#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--phases NAME ...]

Run from the root of the repository. It builds the port's CUDA kernels from
the sources in the checkout, holds each kernel against its plain PyTorch
version on the card, times it, and drives the port's two main paths at the
full RoBERTa-large width on `cuda`: the heat-map sort evaluation
(`trainers.eval --sort_method heat_map`, through `run_eval`) and fine-tuning
(`trainers.train --hierarchical_version v1`, through `main_train`), whose
checkpoint the evaluation then loads. The `hf_path` phase writes a local HF
RoBERTa-large directory of random weights, fine-tunes from it, sweeps its
checkpoints with `--device_decode --eval_all_checkpoints`, holds the card's
order decode against the CPU's, and times device against host decode and
the native packer against numpy; `remat` holds a train step with
`EncoderConfig.remat` against one without. The multimodal CLIP-RN50 path:
`mm_check` holds the full-width RN50 tower on the card against the CPU,
`mm_reference` a 2-layer full-width joint sequencer (forward and 4 train
steps, BatchNorm statistics included), `mm_path` trains the full-width
joint sequencer through `main_train --multimodal` on stories with PNG step
images and evaluates its checkpoint with host and `--device_decode`
decode, and `mm_breakdown` profiles its train step and eval forward. The
BERSON ordering wrapper: `berson_reference` holds a 2-layer full-width
BERSON (text inner, and CLIP-RN50 inner with a frozen tower) on the card
against the CPU (encode intermediates, pointer logits, loss, beam orders
and four train steps), and `berson_path` trains and beam-evaluates the
full-width text BERSON and the reference launcher's CLIP-RN50 BERSON
through the CLIs and profiles a step and an eval batch. The other ordering
heads: `heads_reference` holds 2-layer full-width p0 and p1 sequencers
with their auxiliary heads and the pure_decode encoder-decoder on the card
against the CPU (logits, loss terms, gradients, the greedy decode and the
generated tokens), and `heads_path` trains p0, p1, the CLIP-RN50 heat map
with `itm` and the pure_decode model through `main_train` at RoBERTa-large
and evaluates the pointer substitution and the beam-5 generate. The
VisualBERT and naive encoders: `visual_reference` holds 2-layer
full-width VisualBERT (sidecars; an FPN tower on the sidecar sentinel),
naive, BERSON-over-VisualBERT and inline-ROI pretraining models on the
card against the CPU (outputs, loss terms, gradients, BatchNorm
statistics, decodes), and `visual_path` runs them at RoBERTa-large through
`main_train` and `main_pretrain` with exact launch counts. The parallel
layer: `parallel_path` runs fine-tune steps at RoBERTa-large under
`torchrun` (one rank, NCCL) with `--fsdp` and with DDP, held against the
same steps in one process (losses, gradient norms, launches a step);
`kernel_check` holds the flash kernels at a tensor-parallel rank's local
shapes (8 of 16 heads) with the keep bits of a global (batch, head) index,
and the LayerNorm at a sequence-parallel rank's rows. `tools_path` runs
both feature extractors on the card (the CLIP RN50 tower at 224 px, the
ResNet-50-FPN ROI tower at 256 px with K = 10 sidecars), holds a few
images against the CPU, reads the sidecars back, and checks that a
`--profile_dir` trace of a train run holds the hand-written kernels by
name. `pipeline_path` runs the GPipe steps with every stage in this
process (RoBERTa-large fine-tune steps at 2 x 2 and 4 x 4, BERSON's text
trunk at 2 x 2) against the unpipelined steps on the same weights and
batches (the first two losses within 1e-6, the rest and the gradient
norms within the spread's limits, n_micro times the layers' launches),
and ring attention over a 4096-token sequence (bf16 on 4 positions, f32
on 2) against the whole sequence's flash kernels and f64, the output's
limit scaled to its largest value and shown to catch a dropped key block,
with exact launches;
`kernel_check` holds the flash kernels at a pipelined microbatch's calls
and at a ring block with the main backward kernel under the global lse.
It also holds them at head widths 128, 96 and 48 (the last two zero-padded
to 128 and 64), at 4097 x 16 batch*heads, and the backward at lengths
whose heads have more q tiles than the main kernel's cooperative grid
holds lanes (`LONG_SHAPES`, against plain versions taken by rows), each
bf16 backward bit-equal on rerun; `bits_check` dumps 4097 x 16 heads and
ragged lengths through the bf16 kernels' fragment maps.
Every output line
before the last is one JSON object (plus the raw `nvidia-smi` line and the
paper-format eval rows); the last line is the contract line
`{"ok": true, "device": {...}}`, printed only when every phase passed. Without a CUDA device, or without the
port's package beside it, it exits non-zero and prints no result.
`--phases` runs a subset (the build always runs); the contract line then
is not printed. The card-against-CPU phases (`REFERENCE_PHASES`), whose
time is their CPU side, run in a second process of this script
(`--reference_worker`, on `REFERENCE_THREADS` CPU threads) beside the
card paths, started once `timing` has read the kernels' times; their
lines follow the card paths' lines, and a phase that fails there fails
the run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

# (B, H, S, D): the eval shape (micro-batch 32 = eval batch 8 x 4, 16 heads
# of 64, S = 320), the multimodal joint stream's unaligned S = 566, several
# 64-key tiles at S = 1024, the tiny test config's head dim 16; the head
# widths of HF configs the kernels run padded or at 128 (hidden 768 with 6
# heads: 128; 1536 with 16: 96; 768 with 16: 48) at the train step's batch
# and length; more batch*heads than a grid's y takes (4097 x 16 > 65535);
# and the train shape (batch 8)
KERNEL_SHAPES = [(32, 16, 320, 64), (4, 16, 566, 64), (2, 16, 1024, 64),
                 (2, 4, 40, 16), (8, 6, 320, 128), (8, 16, 320, 96),
                 (8, 16, 320, 48), (4097, 16, 16, 64), (8, 16, 320, 64)]
EVAL_SHAPE, TRAIN_SHAPE = KERNEL_SHAPES[0], KERNEL_SHAPES[-1]
D128_SHAPE = (8, 6, 320, 128)
# The bf16 backward with more q tiles in a head than the main kernel's
# cooperative grid holds lanes (264 at D = 64, 132 at D = 128 on an H100):
# 480 and 256 tiles, so each head's key tiles split into two groups of
# accumulator slices. Held against the plain versions taken 2048 q rows at
# a time (`fwd_reference_by_rows`, `bwd_reference_by_rows`).
LONG_SHAPES = [(1, 2, 30720, 64), (1, 1, 16384, 128)]
REFERENCE_ROWS = 2048
DROPOUT_P = 0.1
# Forward: |got - want| <= atol + rtol * |want| for O, <= atol for lse. f32:
# the kernel and the plain version do the same f32 arithmetic in another
# order. bf16: both round the probabilities to bf16 before P.V and the
# output to bf16, so O may differ by one bf16 ulp (2^-7 relative at the
# bottom of a binade); lse is f32 in both.
TOLERANCE = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 1e-2)}
# Backward (dq, dk, dv): |got - want| <= atol * max|want| + rtol * |want|.
# f32: the same f32 sums in another order. bf16: the kernels round p and ds
# to bf16 before their products (the plain version keeps them f32) and the
# gradients to bf16, so each gradient may be off by a few bf16 ulps of the
# largest entries of its row.
BWD_TOLERANCE = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
# The keep-bit hash's least work an element: 10 integer operations (the
# counter's add, since the counter is linear in the position; mix32's three
# shifts, three xors, the last with the 31-bit mask, and two multiplies;
# the compare). An SM issues 4 warp instructions a clock, and its integer
# ALU pipe and its FMA pipe (IMAD, which also shifts and adds) take 64
# lanes each: 128 integer operations an SM a clock, at the card's SM count
# and maximum SM clock as read in the run (an estimate, not a
# measurement). The ALU pipe alone, 64 lanes, is what the compiled dump's
# shifts, xors and byte permutes wait on (`dump_sass_per_element`).
HASH_OPS_PER_ELEMENT = 10
INT_OPS_PER_SM_CLOCK = 128
ALU_LANES_PER_SM_CLOCK = 64
NUM_LAYERS = 24  # RoBERTa-large: one attention call per layer per forward
N_STORIES = 40   # eval: 5 batches of 8
TRAIN_STEPS = 8  # train: steps of 8 stories
HF_STEPS = 4     # the HF path: steps of 8 stories, a checkpoint every 2
MM_STEPS = 8     # the multimodal path: steps of 8 stories of 5 step images
MM_IMAGE = 224   # the RN50 tower's resolution: a 7 x 7 grid an image
# the folded visual stream: 5 images x 7 x 7 patches + the mean token
MM_VISUAL_TOKENS = 5 * 7 * 7 + 1
MM_JOINT_S = 320 + MM_VISUAL_TOKENS  # 566


def per_forward(layers, extra_ln=0, extra_attn=0):
    """Kernel launches of one forward (and, for the backward kernels, a
    train step) of an encoder of `layers` layers: an attention and a GELU a
    layer, two LayerNorms a layer and the embeddings'; `extra_attn` more
    attention calls (the RN50 attention pool) and `extra_ln` more
    LayerNorms (visn_ln, BERSON's paragraph encoder, the pretraining
    heads)."""
    attn, ln = layers + extra_attn, 2 * layers + 1 + extra_ln
    return {"flash_fwd": attn, "flash_bwd_prep": attn,
            "flash_bwd_main": attn, "flash_bwd_post": attn,
            "gelu_logit_erf_fwd": layers, "gelu_logit_erf_bwd": layers,
            "layer_norm_fwd": ln, "layer_norm_bwd": ln}


# the text path's forward (LayerNorm: 2 per layer + the embeddings')
PER_FORWARD = per_forward(NUM_LAYERS)
# per multimodal forward: 24 joint attentions + the attention pool; the
# LayerNorms of the text path + visn_ln
MM_PER_FORWARD = per_forward(NUM_LAYERS, extra_ln=1, extra_attn=1)
# BERSON (models/berson.py): a 5-step story is P = 20 ordered step pairs of
# L = 2 x 60 tokens; the multimodal inner folds each pair's two images into
# 2 x 7 x 7 + 1 = 99 visual tokens after its text
BERSON_P, BERSON_L = 20, 120
BERSON_MM_S = BERSON_L + 2 * 7 * 7 + 1  # 219
BERSON_STEPS = 8         # text: main_train steps of 2 stories
BERSON_EVAL_STORIES = 48  # text eval: 3 batches of 16 stories, beam 16
BERSON_MM_STEPS = 4      # the launcher's configuration: steps of 1 story
BERSON_MM_EVAL_STORIES = 6  # at its eval batch of 1
# kernel launches a forward (and, for the backward kernels, a train step):
# the 24 inner layers (LayerNorm: + the embeddings' and the paragraph
# encoder's four, which run in f32); the multimodal inner adds the
# attention pool's flash calls and visn_ln
BERSON_PER_FORWARD = per_forward(NUM_LAYERS, extra_ln=4)
BERSON_MM_PER_FORWARD = per_forward(NUM_LAYERS, extra_ln=5, extra_attn=1)
# pretraining (models/pretrainer.py): the objectives that subsample keep 2
# of a story's 5 steps, 2 x 60 text tokens and a folded stream of
# 2 x 7 x 7 + 1 = 99 visual tokens, at the launchers' batch of 4 stories;
# the image-only launcher cuts the language to its CLS token (bert-base:
# 12 heads of 64, 12 layers)
PRETRAIN_L = 120
PRETRAIN_VISUAL = 2 * 7 * 7 + 1  # 99
PRETRAIN_STEPS = 8        # the two RoBERTa-large runs
PRETRAIN_IMG_STEPS = 4    # the image-only run
PRETRAIN_DEV_STORIES = 4  # the dev split, at the launchers' eval batch of 1
# RecipeQA's launchers (scripts/recipeqa_*.sh) at bert-base widths (12
# layers, 12 heads of 64, 768 / 3072 wide); BERSON's forward there: the 12
# inner layers (+ the attention pool), LayerNorm 2 x 12 + the embeddings'
# and the paragraph encoder's four (+ visn_ln)
RQ_LAYERS = 12
RQ_TRAIN = 16            # train recipes (new_splits train-human_annot)
RQ_TEST = 3              # test recipes, the last of them human-annotated
RQ_FT_STEPS = 4          # the finetune launcher: steps of 1 recipe,
RQ_FT_SAVE = 3           # a save with its beam eval at step 3, then step 4
RQ_PRE_STEPS = 4         # each pretraining launcher: steps of 4 recipes
RQ_PER_FORWARD = per_forward(RQ_LAYERS, extra_ln=5, extra_attn=1)
# VisualBERT and the naive model (models/visualbert.py, naive_model.py): a
# token an image, after VisualBERT's K = 10 regional tokens an image from
# the ROI sidecars (S = 320 + 5 x 11) or, in pretraining over the FPN tower
# at 256 px, from inline ROI (300 + 5 x 11); the naive model's tokens, and
# VisualBERT's over an FPN sequencer whose sidecars are missing (the
# sentinel), one an image (320 + 5); BERSON's pairs of 120 text tokens and
# their 2 image tokens
VB_K = 10
VB_S = 320 + 5 * (1 + VB_K)            # 375
NAIVE_S = 320 + 5                      # 325
VB_BERSON_S = BERSON_L + 2             # 122
VB_PRETRAIN_S = 300 + 5 * (1 + VB_K)   # 355
FPN_IMAGE = 256
VB_STEPS = 4             # (a)-(c): main_train steps of 8 stories
VB_EVAL_STORIES = 16     # (a): --do_eval of 16 stories, micro-batch 32
VB_BERSON_STEPS = 2      # (d): steps of 1 story (20 pairs)
VB_PRETRAIN_STEPS = 2    # (e): steps of 4 stories
# a forward's launches: the text path's and the visual embeddings'
# LayerNorm (f32); BERSON's with its paragraph encoder's four; the
# pretrainer's with the MLM head's
VB_PER_FORWARD = per_forward(NUM_LAYERS, extra_ln=1)
NAIVE_PER_FORWARD = per_forward(NUM_LAYERS)
VB_BERSON_PER_FORWARD = per_forward(NUM_LAYERS, extra_ln=5)
VB_PRETRAIN_PER_FORWARD = per_forward(NUM_LAYERS, extra_ln=2)
# the v0 baselines (RoBERTa-large): steps of 8 pairs / stories at S = 320,
# and an eval of 8 stories (one batch): 160 ordered step pairs packed to
# pair_len = 128 and 480 step triples packed to 320, at micro-batch 32
V0_STEPS = 4
V0_EVAL_STORIES = 8
V0_PAIR_LEN = 128
# the published roberta-large config.json, as a local HF directory has it
HF_ROBERTA_LARGE = {
    "architectures": ["RobertaForMaskedLM"], "model_type": "roberta",
    "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
    "intermediate_size": 4096, "hidden_act": "gelu", "vocab_size": 50265,
    "max_position_embeddings": 514, "type_vocab_size": 1,
    "layer_norm_eps": 1e-5, "pad_token_id": 1, "bos_token_id": 0,
    "eos_token_id": 2, "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02}
# the decoders `--device_decode` runs on the card
DEVICE_DECODE_METHODS = ("naive", "naive_v2", "naive_v3", "naive_sum",
                         "naive_v2_sum", "naive_v3_sum", "topological")
# two orders the card and the CPU decode differently must tie: their f64
# scores agree within this, relative to max(1, |score|) (f32 sums of a few
# logs near 20 round at ~2e-6)
DECODE_TIE_REL = 1e-6
BITS_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/keep_bits_dump.cu"
GELU_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/gelu.cu"
BWD_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/flash_bwd.cu"
LN_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/layer_norm.cu"
KERNELS = {
    "flash_fwd": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                  "multimodal_sequencing_tpu/ops/attention.py:126"),
    # the whole bf16 backward (pre-pass, main kernel, post-pass)
    "flash_bwd": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
    # both at head width 128 (the kernels' D = 128 instances), at an HF
    # config's train step of hidden 768 and 6 heads (D128_SHAPE)
    "flash_fwd@d128": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                       "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_bwd@d128": (BWD_KERNEL,
                       "multimodal_sequencing_tpu/ops/attention.py:343"),
    # the two TPU kernels, both computed by one pass of the main kernel
    "flash_bwd_dq": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:234"),
    "flash_bwd_dkv": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:283"),
    # not TPU kernels: delta = rowsum(dO * O), which the JAX package leaves
    # to XLA, and dq's cast from the f32 accumulator
    "flash_bwd_prep": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:377"),
    "flash_bwd_post": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:234"),
    "keep_bits_dump": (BITS_KERNEL,
                       "multimodal_sequencing_tpu/ops/attention.py:502"),
    "keep_bits_dump@verify": (BITS_KERNEL,
                              "scripts/verify_hw_dropout_bits.py:76"),
    # not TPU kernels: the JAX package leaves the logit_erf GELU to XLA
    "gelu_logit_erf_fwd": (GELU_KERNEL,
                           "multimodal_sequencing_tpu/ops/gelu.py:163"),
    # the same kernel at the eval shape
    "gelu_logit_erf_fwd@eval": (GELU_KERNEL,
                                "multimodal_sequencing_tpu/ops/gelu.py:163"),
    "gelu_logit_erf_bwd": (GELU_KERNEL,
                           "multimodal_sequencing_tpu/ops/gelu.py:175"),
    # nor the Flax LayerNorm the JAX encoder calls (models/encoder.py:146)
    "layer_norm_fwd": (LN_KERNEL,
                       "multimodal_sequencing_tpu/models/encoder.py:146"),
    # the same kernel at the eval shape
    "layer_norm_fwd@eval": (LN_KERNEL,
                            "multimodal_sequencing_tpu/models/encoder.py:146"),
    "layer_norm_bwd": (LN_KERNEL,
                       "multimodal_sequencing_tpu/models/encoder.py:146"),
    # the flash kernels at the multimodal path's shapes: the joint stream
    # (S = 566) of a train step and of an eval micro-batch, and the RN50
    # attention pool (S = 246, 32 heads, no mask), which the JAX package
    # computes with an XLA einsum (models/clip_visual.py:172)
    "flash_fwd@joint": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                        "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_fwd@joint_eval": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                             "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_fwd@attnpool": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                           "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_bwd@joint": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
    "flash_bwd@attnpool": (BWD_KERNEL,
                           "multimodal_sequencing_tpu/ops/attention.py:343"),
    # BERSON's calls: the text pairs of a train step (2 stories x 20 pairs,
    # S = 120), the joint pairs of the launcher's step (1 story, S = 219)
    # and their RN50 attention pool (99 tokens, 32 heads, no mask)
    "flash_fwd@pair": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                       "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_fwd@pair_joint": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                             "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_fwd@pair_pool": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                            "multimodal_sequencing_tpu/ops/attention.py:126"),
    # the text pairs of a beam-eval batch (16 stories)
    "flash_fwd@pair_eval": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                            "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_bwd@pair": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
    "flash_bwd@pair_joint": (BWD_KERNEL,
                             "multimodal_sequencing_tpu/ops/attention.py:343"),
    "flash_bwd@pair_pool": (BWD_KERNEL,
                            "multimodal_sequencing_tpu/ops/attention.py:343"),
    # pretraining's calls: the joint stream of a subsampled batch (4
    # stories, S = 120 + 99), its RN50 attention pool (99 tokens, 32 heads,
    # no mask), and the image-only launcher's stream (one text key + 99)
    "flash_fwd@pretrain_joint": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
        "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_fwd@pretrain_pool": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
        "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_fwd@pretrain_img": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
        "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_bwd@pretrain_joint": (
        BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
    "flash_bwd@pretrain_pool": (
        BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
    "flash_bwd@pretrain_img": (
        BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
    # the text run's stream (4 stories, S = 300: time_contrastive and the
    # NSP objectives keep every step) and margin_loss's doubled rows of two
    # steps; the dev evals' (`mlm_only`, batch 1, nothing subsampled): the
    # launcher's joint stream (300 + 246) and its pool, the text run's, the
    # image-only run's (one text key + 246); the visual transfer's fine-tune
    # step at bert-base widths (S = 566) and its pool
    **{f"flash_fwd@{name}": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
        "multimodal_sequencing_tpu/ops/attention.py:126")
       for name in ("pretrain_text", "pretrain_margin", "pretrain_eval",
                    "pretrain_eval_pool", "pretrain_text_eval",
                    "pretrain_img_eval", "pretrain_ft", "pretrain_ft_pool")},
    **{f"flash_bwd@{name}": (
        BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343")
       for name in ("pretrain_text", "pretrain_margin", "pretrain_ft",
                    "pretrain_ft_pool")},
    # the v0 baselines' calls: a pairwise train step (8 pairs in S = 320),
    # the all-pairs eval (pairs in 128) and the abductive cube (triples in
    # 320); RecipeQA's at bert-base: BERSON's joint pairs (20 x 219), the
    # pretraining launcher's subsampled stream (4 x 219), its dev eval
    # (1 x 546)
    **{f"flash_fwd@{name}": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
        "multimodal_sequencing_tpu/ops/attention.py:126")
       for name in ("v0_pair_train", "v0_pair_eval", "v0_cube_eval",
                    "rq_pair_joint", "rq_pretrain_joint", "rq_pretrain_eval")},
    **{f"flash_bwd@{name}": (
        BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343")
       for name in ("v0_pair_train", "rq_pair_joint", "rq_pretrain_joint")},
    # GELU and LayerNorm at bert-base widths (3072 / 768), at the rows of
    # the RecipeQA finetune launcher's step (20 pairs x 219 tokens)
    "gelu_logit_erf_fwd@bert_base": (
        GELU_KERNEL, "multimodal_sequencing_tpu/ops/gelu.py:163"),
    "gelu_logit_erf_bwd@bert_base": (
        GELU_KERNEL, "multimodal_sequencing_tpu/ops/gelu.py:175"),
    "layer_norm_fwd@bert_base": (
        LN_KERNEL, "multimodal_sequencing_tpu/models/encoder.py:146"),
    "layer_norm_bwd@bert_base": (
        LN_KERNEL, "multimodal_sequencing_tpu/models/encoder.py:146"),
    # VisualBERT and the naive model: the sidecar train step (S = 375) and
    # its eval micro-batch, the one-token-an-image stream (S = 325),
    # BERSON's pairs (S = 122), the inline-ROI pretraining stream (S = 355);
    # the GELU and LayerNorm on the sidecar step's rows, the LayerNorm also
    # in f32 (the first layer's attention_ln takes the f32 joint stream,
    # the visual embeddings' LayerNorm runs in f32)
    **{f"flash_fwd@{name}": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
        "multimodal_sequencing_tpu/ops/attention.py:126")
       for name in ("vb_train", "vb_eval", "naive_train", "vb_berson",
                    "vb_pretrain")},
    **{f"flash_bwd@{name}": (
        BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343")
       for name in ("vb_train", "naive_train", "vb_berson", "vb_pretrain")},
    "gelu_logit_erf_fwd@vb": (GELU_KERNEL,
                              "multimodal_sequencing_tpu/ops/gelu.py:163"),
    "gelu_logit_erf_bwd@vb": (GELU_KERNEL,
                              "multimodal_sequencing_tpu/ops/gelu.py:175"),
    **{f"layer_norm_{d}@{tag}": (
        LN_KERNEL, "multimodal_sequencing_tpu/models/encoder.py:146")
       for d in ("fwd", "bwd") for tag in ("vb", "vb_f32")},
    # a tensor-parallel rank's attention (TP 2: 8 of the 16 heads) in a
    # train step of 8 stories and an eval micro-batch, and a
    # sequence-parallel rank's LayerNorm rows (SP 2: 8 x 160)
    "flash_fwd@tp_train": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                           "multimodal_sequencing_tpu/ops/attention.py:126"),
    "flash_bwd@tp_train": (BWD_KERNEL,
                           "multimodal_sequencing_tpu/ops/attention.py:343"),
    "flash_fwd@tp_eval": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                          "multimodal_sequencing_tpu/ops/attention.py:126"),
    **{f"layer_norm_{d}@sp": (
        LN_KERNEL, "multimodal_sequencing_tpu/models/encoder.py:146")
       for d in ("fwd", "bwd")},
    # the pipelined paths (every stage in one process): a fine-tune
    # microbatch of 2 stages x 2 (4 stories at S = 320) with its MLP rows
    # (4 x 320) through the GELU, BERSON's (one story's 20 text pairs), and
    # a ring attention block (2, 16, 1024, 64) of a 4096-token sequence on
    # 4 positions, its backward the main kernel under the ring's global lse
    **{f"flash_{d}@{name}": (
        "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu" if d == "fwd"
        else BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:"
        + ("126" if d == "fwd" else "343"))
       for d in ("fwd", "bwd") for name in ("pp_train", "pp_pair",
                                            "ring_block")},
    "gelu_logit_erf_fwd@pp": (GELU_KERNEL,
                              "multimodal_sequencing_tpu/ops/gelu.py:163"),
    "gelu_logit_erf_bwd@pp": (GELU_KERNEL,
                              "multimodal_sequencing_tpu/ops/gelu.py:175"),
}
# (B, H, S, D) of the multimodal rows: joint train (batch 8), joint eval
# (micro-batch 32), attention pool of a train batch (8 stories)
MM_SHAPES = {"joint": (8, 16, MM_JOINT_S, 64),
             "joint_eval": (32, 16, MM_JOINT_S, 64),
             "attnpool": (8, 32, MM_VISUAL_TOKENS, 64),
             # BERSON: text pairs of 2 stories (one of 3 live steps: 14 of
             # its 20 pairs fully masked), joint pairs of a story of 4 steps
             # (its 8 dead pairs keep only the 99 visual keys), their pool
             "pair": (2 * BERSON_P, 16, BERSON_L, 64),
             "pair_joint": (BERSON_P, 16, BERSON_MM_S, 64),
             "pair_pool": (BERSON_P, 32, BERSON_MM_S - BERSON_L, 64),
             # the text pairs of a beam-eval batch of 16 stories, every
             # third of 3 or 4 steps (fully masked rows)
             "pair_eval": (16 * BERSON_P, 16, BERSON_L, 64),
             # pretraining: a subsampled batch's joint stream and pool, the
             # image-only launcher's stream
             "pretrain_joint": (4, 16, PRETRAIN_L + PRETRAIN_VISUAL, 64),
             "pretrain_pool": (4, 32, PRETRAIN_VISUAL, 64),
             "pretrain_img": (4, 12, 1 + PRETRAIN_VISUAL, 64),
             "pretrain_text": (4, 16, 300, 64),
             "pretrain_margin": (8, 16, PRETRAIN_L, 64),
             "pretrain_eval": (1, 16, 300 + MM_VISUAL_TOKENS, 64),
             "pretrain_eval_pool": (1, 32, MM_VISUAL_TOKENS, 64),
             "pretrain_text_eval": (1, 16, 300, 64),
             "pretrain_img_eval": (1, 12, 1 + MM_VISUAL_TOKENS, 64),
             "pretrain_ft": (4, 12, MM_JOINT_S, 64),
             "pretrain_ft_pool": (4, 32, MM_VISUAL_TOKENS, 64),
             # the v0 baselines: a pairwise train step (two steps in 320),
             # the all-pairs eval micro-batch (two steps in 128), the
             # abductive cube's (three steps in 320)
             "v0_pair_train": (8, 16, 320, 64),
             "v0_pair_eval": (32, 16, V0_PAIR_LEN, 64),
             "v0_cube_eval": (32, 16, 320, 64),
             # RecipeQA at bert-base: BERSON's joint pairs of a 5-step
             # recipe, the subsampled pretraining stream, its dev eval
             "rq_pair_joint": (BERSON_P, 12, BERSON_MM_S, 64),
             "rq_pretrain_joint": (4, 12, PRETRAIN_L + PRETRAIN_VISUAL, 64),
             "rq_pretrain_eval": (1, 12, 300 + MM_VISUAL_TOKENS, 64),
             # VisualBERT and the naive model: the sidecar train step and
             # its eval micro-batch, the one-token-an-image stream, BERSON's
             # pairs, the inline-ROI pretraining stream
             "vb_train": (8, 16, VB_S, 64),
             "vb_eval": (32, 16, VB_S, 64),
             "naive_train": (8, 16, NAIVE_S, 64),
             "vb_berson": (BERSON_P, 16, VB_BERSON_S, 64),
             "vb_pretrain": (4, 16, VB_PRETRAIN_S, 64),
             # a tensor-parallel rank (TP 2) of the text path: its 8 heads
             # of a train step and of an eval micro-batch
             "tp_train": (8, 8, 320, 64),
             "tp_eval": (32, 8, 320, 64),
             # a pipelined step's microbatch (2 of the batch of 8); one
             # BERSON story's pairs (2 of the batch of 2 stories, the story
             # of 3 live steps: 14 pairs fully masked)
             "pp_train": (4, 16, 320, 64),
             "pp_pair": (BERSON_P, 16, BERSON_L, 64)}
# the global (batch offset, head offset, heads) of the tensor-parallel
# calls' keep bits: data rank 1 and model rank 1 of a 2 x 2 layout
MM_INDEX = {"tp_train": (8, 8, 16), "tp_eval": (32, 8, 16)}
# the live steps of each story in `pair_eval`
PAIR_EVAL_STEPS = tuple(5 if a % 3 else 3 + a % 2 for a in range(16))
# the calls of an eval forward: forward only
EVAL_ONLY = ("joint_eval", "pair_eval", "pretrain_eval", "pretrain_eval_pool",
             "pretrain_text_eval", "pretrain_img_eval", "v0_pair_eval",
             "v0_cube_eval", "rq_pretrain_eval", "vb_eval", "tp_eval")
# the calls a train step makes with attention dropout
PATH_DROPOUT = ("joint", "pair", "pair_joint", "pretrain_joint",
                "pretrain_img", "pretrain_text", "pretrain_margin",
                "pretrain_ft", "v0_pair_train", "rq_pair_joint",
                "rq_pretrain_joint", "vb_train", "naive_train", "vb_berson",
                "vb_pretrain", "tp_train", "pp_train", "pp_pair")
# the kernels each main path must launch
PATH_KERNELS = {"eval": ("flash_fwd", "gelu_logit_erf_fwd", "layer_norm_fwd"),
                "train": ("flash_fwd", "flash_bwd_prep", "flash_bwd_main",
                          "flash_bwd_post", "gelu_logit_erf_fwd",
                          "gelu_logit_erf_bwd", "layer_norm_fwd",
                          "layer_norm_bwd")}
# the HF path: training from the HF directory, the sweep of its checkpoints
PATH_KERNELS.update(hf_train=PATH_KERNELS["train"],
                    hf_eval=PATH_KERNELS["eval"],
                    mm_train=PATH_KERNELS["train"],
                    mm_eval=PATH_KERNELS["eval"],
                    berson_train=PATH_KERNELS["train"],
                    berson_eval=PATH_KERNELS["eval"],
                    berson_mm_train=PATH_KERNELS["train"],
                    berson_mm_eval=PATH_KERNELS["eval"],
                    pretrain_train=PATH_KERNELS["train"],
                    pretrain_text=PATH_KERNELS["train"],
                    pretrain_img=PATH_KERNELS["train"],
                    pretrain_train_eval=PATH_KERNELS["eval"],
                    pretrain_text_eval=PATH_KERNELS["eval"],
                    pretrain_img_eval=PATH_KERNELS["eval"],
                    pretrain_finetune=PATH_KERNELS["train"],
                    rq_finetune=PATH_KERNELS["train"],
                    rq_finetune_eval=PATH_KERNELS["eval"],
                    rq_pretrain=PATH_KERNELS["train"],
                    rq_pretrain_eval=PATH_KERNELS["eval"],
                    rq_img=PATH_KERNELS["train"],
                    rq_img_eval=PATH_KERNELS["eval"],
                    v0_pairwise=PATH_KERNELS["train"],
                    v0_head=PATH_KERNELS["train"],
                    **{f"v0_{m}": PATH_KERNELS["eval"] for m in (
                        "topological", "topological_device",
                        "head_and_topological", "head_and_sequential",
                        "head_and_sequential_abductive", "pure_class")},
                    # the heads runs (`phase_heads_path`) and their evals
                    heads_p0=PATH_KERNELS["train"],
                    heads_p0_eval=PATH_KERNELS["eval"],
                    heads_p1=PATH_KERNELS["train"],
                    heads_p1_eval=PATH_KERNELS["eval"],
                    heads_mm_itm=PATH_KERNELS["train"],
                    heads_decode=PATH_KERNELS["train"],
                    heads_decode_eval=PATH_KERNELS["eval"],
                    # the visual runs (`phase_visual_path`) and their evals
                    vb_train=PATH_KERNELS["train"],
                    vb_eval=PATH_KERNELS["eval"],
                    vb_fpn_train=PATH_KERNELS["train"],
                    naive_train=PATH_KERNELS["train"],
                    vb_berson_train=PATH_KERNELS["train"],
                    vb_berson_eval=PATH_KERNELS["eval"],
                    vb_pretrain=PATH_KERNELS["train"],
                    # the parallel runs (`phase_parallel_path`) and the
                    # profiled run (`phase_tools_path`)
                    parallel_one=PATH_KERNELS["train"],
                    parallel_ddp=PATH_KERNELS["train"],
                    parallel_fsdp=PATH_KERNELS["train"],
                    tools_profile=PATH_KERNELS["train"],
                    # the pipelined runs and the ring attention
                    # (`phase_pipeline_path`)
                    pp_unpipelined=PATH_KERNELS["train"],
                    pp_finetune_2x2=PATH_KERNELS["train"],
                    pp_finetune_4x4=PATH_KERNELS["train"],
                    pp_berson=PATH_KERNELS["train"],
                    pp_ring=("flash_fwd", "flash_bwd_prep", "flash_bwd_main",
                             "flash_bwd_post"),
                    pp_ring_f32=("flash_fwd", "flash_bwd_dq_f32",
                                 "flash_bwd_dkv_f32"))
# the launch counter behind each row of the `kernels` line, where it is
# not the row's own name
COUNTER = {"flash_bwd": "flash_bwd_main", "flash_bwd_dq": "flash_bwd_main",
           "flash_bwd_dkv": "flash_bwd_main",
           # no path of this script runs 128-wide heads: the wrappers'
           # counters are shared by every width
           "flash_fwd@d128": "flash_fwd", "flash_bwd@d128": "flash_bwd_main",
           "keep_bits_dump@verify": "keep_bits_dump",
           "gelu_logit_erf_fwd@eval": "gelu_logit_erf_fwd",
           "layer_norm_fwd@eval": "layer_norm_fwd",
           "flash_fwd@joint": "flash_fwd", "flash_fwd@joint_eval": "flash_fwd",
           "flash_fwd@attnpool": "flash_fwd",
           "flash_bwd@joint": "flash_bwd_main",
           "flash_bwd@attnpool": "flash_bwd_main",
           "flash_fwd@pair": "flash_fwd", "flash_fwd@pair_joint": "flash_fwd",
           "flash_fwd@pair_pool": "flash_fwd",
           "flash_fwd@pair_eval": "flash_fwd",
           "flash_bwd@pair": "flash_bwd_main",
           "flash_bwd@pair_joint": "flash_bwd_main",
           "flash_bwd@pair_pool": "flash_bwd_main",
           "flash_fwd@tp_train": "flash_fwd", "flash_fwd@tp_eval": "flash_fwd",
           "flash_bwd@tp_train": "flash_bwd_main",
           "layer_norm_fwd@sp": "layer_norm_fwd",
           "layer_norm_bwd@sp": "layer_norm_bwd",
           **{name: name.split("@")[0].replace("flash_bwd", "flash_bwd_main")
              for name in KERNELS if "@pretrain_" in name or "@v0_" in name
              or "@rq_" in name or "@bert_base" in name or "@vb" in name
              or "@naive" in name or "@pp" in name or "@ring" in name}}
# the path whose launches the multimodal rows of the `kernels` line show
# (the wrappers count launches of every shape together)
ROW_PATH = {"flash_fwd@d128": "train", "flash_bwd@d128": "train",
            "flash_fwd@joint": "mm_train", "flash_fwd@joint_eval": "mm_eval",
            "flash_fwd@attnpool": "mm_train", "flash_bwd@joint": "mm_train",
            "flash_bwd@attnpool": "mm_train",
            "flash_fwd@pair": "berson_train", "flash_bwd@pair": "berson_train",
            "flash_fwd@pair_joint": "berson_mm_train",
            "flash_bwd@pair_joint": "berson_mm_train",
            "flash_fwd@pair_pool": "berson_mm_train",
            "flash_bwd@pair_pool": "berson_mm_train",
            "flash_fwd@pair_eval": "berson_eval",
            "flash_fwd@pretrain_joint": "pretrain_train",
            "flash_bwd@pretrain_joint": "pretrain_train",
            "flash_fwd@pretrain_pool": "pretrain_train",
            "flash_bwd@pretrain_pool": "pretrain_train",
            "flash_fwd@pretrain_img": "pretrain_img",
            "flash_bwd@pretrain_img": "pretrain_img",
            "flash_fwd@pretrain_text": "pretrain_text",
            "flash_bwd@pretrain_text": "pretrain_text",
            "flash_fwd@pretrain_margin": "pretrain_text",
            "flash_bwd@pretrain_margin": "pretrain_text",
            "flash_fwd@pretrain_eval": "pretrain_train_eval",
            "flash_fwd@pretrain_eval_pool": "pretrain_train_eval",
            "flash_fwd@pretrain_text_eval": "pretrain_text_eval",
            "flash_fwd@pretrain_img_eval": "pretrain_img_eval",
            "flash_fwd@pretrain_ft": "pretrain_finetune",
            "flash_bwd@pretrain_ft": "pretrain_finetune",
            "flash_fwd@pretrain_ft_pool": "pretrain_finetune",
            "flash_bwd@pretrain_ft_pool": "pretrain_finetune",
            "flash_fwd@v0_pair_train": "v0_pairwise",
            "flash_bwd@v0_pair_train": "v0_pairwise",
            "flash_fwd@v0_pair_eval": "v0_topological",
            "flash_fwd@v0_cube_eval": "v0_head_and_sequential_abductive",
            "flash_fwd@rq_pair_joint": "rq_finetune",
            "flash_bwd@rq_pair_joint": "rq_finetune",
            "flash_fwd@rq_pretrain_joint": "rq_pretrain",
            "flash_bwd@rq_pretrain_joint": "rq_pretrain",
            "flash_fwd@rq_pretrain_eval": "rq_pretrain_eval",
            **{f"{k}@bert_base": "rq_finetune" for k in (
                "gelu_logit_erf_fwd", "gelu_logit_erf_bwd", "layer_norm_fwd",
                "layer_norm_bwd")},
            "flash_fwd@vb_train": "vb_train", "flash_bwd@vb_train": "vb_train",
            "flash_fwd@vb_eval": "vb_eval",
            "flash_fwd@naive_train": "naive_train",
            "flash_bwd@naive_train": "naive_train",
            "flash_fwd@vb_berson": "vb_berson_train",
            "flash_bwd@vb_berson": "vb_berson_train",
            "flash_fwd@vb_pretrain": "vb_pretrain",
            "flash_bwd@vb_pretrain": "vb_pretrain",
            # the card runs one rank: its FSDP steps launch the kernels at
            # the single process's shapes (every shape counted together)
            **{k: "parallel_fsdp" for k in (
                "flash_fwd@tp_train", "flash_bwd@tp_train",
                "flash_fwd@tp_eval", "layer_norm_fwd@sp",
                "layer_norm_bwd@sp")},
            **{f"{k}@{tag}": "vb_train" for k in (
                "gelu_logit_erf_fwd", "gelu_logit_erf_bwd", "layer_norm_fwd",
                "layer_norm_bwd") for tag in ("vb", "vb_f32")
               if tag == "vb" or k.startswith("layer_norm")},
            **{k: "pp_finetune_2x2" for k in (
                "flash_fwd@pp_train", "flash_bwd@pp_train",
                "gelu_logit_erf_fwd@pp", "gelu_logit_erf_bwd@pp")},
            "flash_fwd@pp_pair": "pp_berson", "flash_bwd@pp_pair": "pp_berson",
            "flash_fwd@ring_block": "pp_ring",
            "flash_bwd@ring_block": "pp_ring"}
# the f32 backward kernels: the check path, never launched by the bf16
# train path
F32_BWD = ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")
# LayerNorm inputs: (rows, features, mean); rows of std 1 around `mean`
# the rows of the RecipeQA launchers' steps at bert-base widths: the
# pretraining one's (4 x 219), then the finetune one's (20 pairs x 219),
# whose rows the kernels line shows
RQ_ROWS = BERSON_P * BERSON_MM_S
SP_ROWS = 8 * 320 // 2  # a train step's rows on one of two SP ranks
LN_SHAPES = [(32 * 320, 1024, 0.0), (8 * 320, 1024, 0.0), (8 * 320, 1024, 3.0),
             (7, 64, 0.0), (37, 1000, 0.0),  # 1000: not whole 16-byte vectors
             (8 * VB_S, 1024, 0.0),  # VisualBERT's train step (f32 too)
             (4 * BERSON_MM_S, 768, 0.0), (RQ_ROWS, 768, 0.0),
             (SP_ROWS, 1024, 0.0)]  # a sequence-parallel rank (SP 2)
# |got - want| <= atol + rtol * |want| (dw, db: atol relative to the largest
# entry). f32: the same formula, f32 sums in another order; bf16: one bf16
# ulp of the output, and dx is rounded from f32 in both.
LN_TOLERANCE = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7)}
# Two more LayerNorm cases, as (rows, features, mean, x storage offset in
# elements, constant rows): x one element past a 16-byte boundary (every row
# takes the kernels' scalar path), and rows of one value each, at the
# clamp's edge: the value has 7 significant bits, so its square and every
# sum of up to 1024 copies of either are exact in f32, the variance is 0 in
# any order of sums and y = b. (With more bits the rounded variance, below
# or above 0 by ~1e-7, moves rsqrt(var + eps) by ~1 % in a way that depends
# on the order of sums, so no two implementations agree on dx.)
LN_EDGE_CASES = [(8 * 320, 1024, 0.0, 1, False), (8 * 320, 1024, 3.0, 0, True)]
# rows of the eval shape whose statistics the forward and backward must
# share bit for bit (see _layer_norm_shared_stats)
LN_STATS_ROWS = (0, 4321, 32 * 320 - 1)
# the MLP activation entering the GELU: (tokens, intermediate size)
PP_ROWS = 4 * 320  # the MLP rows of a pipelined fine-tune microbatch
GELU_SHAPES = [(32 * 320, 4096), (8 * 320, 4096), (5, 7), (8 * VB_S, 4096),
               (4 * BERSON_MM_S, 3072), (PP_ROWS, 4096), (RQ_ROWS, 3072)]
# |got - want| <= atol + rtol * |want|. f32: the kernel and the plain
# version round the same f32 formula in other places (fused multiply-adds
# outside the polynomials), an ulp of sigma and u' that the backward's
# x sigma (1 - sigma) u' magnifies up to ~10x; bf16: one bf16 ulp.
GELU_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}
# What a 16-byte vector kernel can get wrong, as (n, x offset, g offset) in
# elements: n = 1, 7 and 8k + 3 (a scalar tail), x and g at a storage offset
# that is not a multiple of 8 elements (a scalar head), x and g on
# different 16-byte phases (every element scalar)
GELU_EDGE_CASES = [(1, 0, 0), (7, 0, 0), (8 * 4099 + 3, 0, 0), (8005, 3, 3),
                   (8005, 3, 0)]
# The GELU's instruction floor: SASS instructions an element of its vector
# loop, the FP32 pipe's at 128 lanes an SM a clock, MUFU's (ex2, rcp) at 16
FP32_PIPE = {"FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FSET",
             "FFMA32I", "FMUL32I", "FADD32I"}
LANES_PER_SM_CLOCK = 128
MUFU_PER_SM_CLOCK = 16
# the integer ALU pipe's opcodes in the keep-bit dump's SASS (IMAD and
# VIADD counted apart)
INT_ALU = {"IADD3", "LOP3", "SHF", "PRMT", "ISETP", "LEA", "SEL", "IMNMX",
           "IABS", "MOV", "SGXT", "BMSK"}

WORDS = ("gather measure cut sand paint attach tighten clean check wait mark "
         "drill fold press rinse dry lift turn slide align glue clamp trim "
         "wipe pour stir heat cool fill empty open close label store").split()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bytes_written():
    """The bytes this process and its reaped children (the parallel `nvcc`
    builds, which `_build` waits for) have written so far: `wchar` of
    /proc/self/io, which takes in each child's count when it is reaped;
    None where the kernel does not report it. The card machine allows 45
    GiB of disk writes to the whole script."""
    try:
        with open("/proc/self/io") as f:
            return int(dict(line.split(": ") for line in
                            f.read().splitlines())["wchar"])
    except (OSError, KeyError, ValueError):
        return None


def cuda_ms(fn, iters: int = 30, warmup: int = 3,
            device_only: bool = False) -> float:
    """Mean time of one call on the card, by CUDA events over `iters` calls.
    Without `device_only` the time includes any gap in which the card waits
    for the host (a train step, a forward). With it, the card first spins
    for ~25 ms while the host queues every call, so a kernel that runs for
    less than its wrapper's host time is timed by the card's work alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if device_only:
        torch.cuda._sleep(50_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 30) -> float:
    """`cuda_ms` of the card's work alone (kernels and their plain versions)."""
    return cuda_ms(fn, iters, device_only=True)


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def int_bound(nbytes: float, int_ops: float, int_ops_per_s: float) -> dict:
    """`bound` for integer work: the bytes against the integer operations
    at `int_ops_per_s` (INT_OPS_PER_SM_CLOCK at the card's SMs and maximum
    clock)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = int_ops / int_ops_per_s * 1e3
    return {"bytes": nbytes, "int_ops": int_ops,
            "bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "int_ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def make_attention_inputs(shape, dtype, seed: int):
    """q, k, v on the card and a (B, S) key mask: batch row 0 keeps 3/4 of
    its keys (a padded tail), the last row keeps none (fully masked), the
    rows between keep random-length prefixes."""
    import torch
    b, h, s, d = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
               for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[0] = max(1, (3 * s) // 4)
    lengths[-1] = 0
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
    return q, k, v, mask.cuda()


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _pair_lengths(live_steps, gen):
    """Token counts of BERSON's pair rows for stories of `live_steps` live
    steps each (of 5): 0 for a pair that touches a dead step (a fully
    masked row), else two steps of 20..60 tokens."""
    import torch
    from multimodal_sequencing_tpu_torch.data.packing import berson_pairs
    pairs = torch.from_numpy(berson_pairs(5)).long()
    rows = []
    for m in live_steps:
        steps = torch.randint(20, 61, (5,), generator=gen)
        rows.append(torch.where((pairs < m).all(1),
                                steps[pairs[:, 0]] + steps[pairs[:, 1]], 0))
    return torch.cat(rows)


def make_path_attention_inputs(name: str, dtype, seed: int):
    """q, k, v and the key mask of a multimodal or BERSON attention call
    (`MM_SHAPES`) as the path gives them to the kernels: head-split views
    of (B, S, H*D) projections. The joint stream keeps 260..320 text keys
    of each row and every visual key (the fine-tune stream too); BERSON's
    pairs their two steps' tokens (none for a dead pair), followed in the
    joint pairs by the 99 visual keys (RecipeQA's at bert-base too); the
    v0 baselines' rows two steps' tokens (a triple's three); pretraining's
    subsampled stream (and margin_loss's rows; RecipeQA's) two steps'
    tokens and the 99 visual keys, its text and dev-eval streams five
    steps' tokens and the 246 visual keys; the
    attention pools have no mask (all ones), nor have the image-only
    streams."""
    import torch
    b, h, s, d = MM_SHAPES[name]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
               .transpose(1, 2) for _ in range(3))
    pos = torch.arange(s)[None, :]
    if name in ("attnpool", "pair_pool", "pretrain_pool", "pretrain_img",
                "pretrain_eval_pool", "pretrain_img_eval", "pretrain_ft_pool"):
        # the image-only stream: its one text key (a CLS) and the visual keys
        mask = torch.ones((b, s), dtype=torch.int32)
    elif name in ("pretrain_joint", "pretrain_margin", "rq_pretrain_joint"):
        # two steps of 20..60 text tokens (and the joint stream's 99 visual)
        text = torch.randint(20, 61, (b, 2), generator=gen).sum(1)[:, None]
        mask = ((pos < text) | (pos >= PRETRAIN_L)).to(torch.int32)
    elif name in ("pretrain_text", "pretrain_text_eval", "pretrain_eval",
                  "rq_pretrain_eval", "vb_pretrain"):
        # five steps of 20..60 text tokens (and the eval's 246 visual)
        text = torch.randint(20, 61, (b, 5), generator=gen).sum(1)[:, None]
        mask = ((pos < text) | (pos >= 300)).to(torch.int32)
    elif name in ("v0_pair_train", "v0_pair_eval", "v0_cube_eval"):
        # a step pair's (a triple's) 20..60 tokens each, the rest padding
        steps = 3 if name == "v0_cube_eval" else 2
        text = torch.randint(20, 61, (b, steps), generator=gen).sum(1)
        mask = (pos < text[:, None]).to(torch.int32)
    elif name in ("pair", "pair_eval", "pp_pair"):
        live = {"pair": (5, 3), "pp_pair": (3,)}.get(name, PAIR_EVAL_STEPS)
        mask = (pos < _pair_lengths(live, gen)[:, None]).to(torch.int32)
    elif name in ("pair_joint", "rq_pair_joint", "vb_berson"):
        # the launcher's story of 4 live steps; a recipe's 5; VisualBERT's
        # BERSON story of 5 (its 2 image keys after the 120 text keys)
        text = _pair_lengths((4,) if name == "pair_joint" else (5,),
                             gen)[:, None]
        mask = ((pos < text) | (pos >= BERSON_L)).to(torch.int32)
    else:
        lengths = torch.randint(260, 321, (b,), generator=gen)
        mask = ((pos < lengths[:, None]) | (pos >= 320)).to(torch.int32)
    return q, k, v, mask.cuda()


# the multimodal and BERSON paths' attention calls the kernel check holds,
# as (name in MM_SHAPES, dropout rate): each train step's call with dropout
# and without (the calls of an eval forward: `EVAL_ONLY`, forward only, and
# the launcher's eval at the train shape), the attention pools
MM_KERNEL_CASES = [("joint", DROPOUT_P), ("joint", 0.0),
                   ("joint_eval", 0.0), ("attnpool", 0.0),
                   ("pair", DROPOUT_P), ("pair", 0.0), ("pair_eval", 0.0),
                   ("pair_joint", DROPOUT_P), ("pair_joint", 0.0),
                   ("pair_pool", 0.0), ("pretrain_joint", DROPOUT_P),
                   ("pretrain_pool", 0.0), ("pretrain_img", DROPOUT_P),
                   ("pretrain_text", DROPOUT_P), ("pretrain_margin", DROPOUT_P),
                   ("pretrain_eval", 0.0), ("pretrain_eval_pool", 0.0),
                   ("pretrain_text_eval", 0.0), ("pretrain_img_eval", 0.0),
                   ("pretrain_ft", DROPOUT_P), ("pretrain_ft_pool", 0.0),
                   ("v0_pair_train", DROPOUT_P), ("v0_pair_eval", 0.0),
                   ("v0_cube_eval", 0.0), ("rq_pair_joint", DROPOUT_P),
                   ("rq_pair_joint", 0.0), ("rq_pretrain_joint", DROPOUT_P),
                   ("rq_pretrain_eval", 0.0), ("vb_train", DROPOUT_P),
                   ("vb_train", 0.0), ("vb_eval", 0.0),
                   ("naive_train", DROPOUT_P), ("vb_berson", DROPOUT_P),
                   ("vb_berson", 0.0), ("vb_pretrain", DROPOUT_P),
                   ("tp_train", DROPOUT_P), ("tp_train", 0.0),
                   ("tp_eval", 0.0), ("pp_train", DROPOUT_P),
                   ("pp_train", 0.0), ("pp_pair", DROPOUT_P)]


def _attention_check(att, q, k, v, mask, p, seed, labels, backward=True,
                     index=None, o_scaled=False, by_rows=False):
    """One forward (and backward) of the flash kernels against the plain
    versions under TOLERANCE and BWD_TOLERANCE; bwd inputs are the kernel
    forward's O and lse and a random dO laid out as q. `index`: the heads'
    global (batch offset, head offset, heads) of the keep bits. With
    `o_scaled` O's atol is TOLERANCE's times max|O| (for outputs far below
    1, as BWD_TOLERANCE scales the gradients). `by_rows`: the plain
    versions taken REFERENCE_ROWS q rows at a time (long S). Returns the
    forward row, the backward row (None without `backward`) and the
    failures."""
    import torch
    name = str(q.dtype).split(".")[-1]
    failed = []
    if index is not None:
        labels = {**labels, "global_bh_index": list(index)}
    o, lse = att.flash_attention(q, k, v, mask, p, seed + 17, index)
    torch.cuda.synchronize()
    if by_rows:
        o_ref, lse_ref = fwd_reference_by_rows(att, q, k, v, mask, p,
                                               seed + 17, index)
    else:
        o_ref, lse_ref = att.attention_reference_lse(q, k, v, mask, p,
                                                     seed + 17, index)
    atol, rtol = TOLERANCE[name]
    o_atol = atol * o_ref.float().abs().max().item() if o_scaled else atol
    ok = all(bool(((got.float() - want.float()).abs()
                   <= a + r * want.float().abs()).all())
             for got, want, a, r in ((o, o_ref, o_atol, rtol),
                                     (lse, lse_ref, atol, 0.0)))
    fwd = {"phase": "kernel_check", "kernel": "flash_fwd", **labels,
           "shape_bhsd": list(q.shape), "dtype": name, "dropout_p": p,
           "max_abs_err_o": _max_err(o, o_ref),
           "max_abs_err_lse": _max_err(lse, lse_ref),
           "atol": atol, "rtol": rtol, "atol_o": o_atol, "ok": ok}
    fwd["max_abs_err"] = max(fwd["max_abs_err_o"], fwd["max_abs_err_lse"])
    dead = ~mask.bool().any(1)  # fully masked batch rows
    if bool(dead.any()):
        # their lse (-1e9 + log S, lost to f32; (B * H, S) rows) bit-equal
        # to the plain one
        dead_bh = dead.repeat_interleave(q.shape[1])
        fwd["fully_masked_rows"] = int(dead.sum())
        fwd["masked_rows_lse_equal"] = torch.equal(lse[dead_bh],
                                                   lse_ref[dead_bh])
        ok = ok and fwd["masked_rows_lse_equal"]
    emit(fwd)
    failed += [] if ok else [("flash_fwd", labels, tuple(q.shape), name, p)]
    if not backward:
        return fwd, None, failed

    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.empty_like(q).copy_(torch.randn(q.shape, generator=gen))
    got = att.flash_attention_bwd(q, k, v, mask, o, lse, do, p, seed + 17,
                                  index)
    torch.cuda.synchronize()
    if by_rows:
        want = bwd_reference_by_rows(att, q, k, v, mask, o, lse, do, p,
                                     seed + 17, index)
    else:
        want = att.attention_bwd_reference(q, k, v, mask, o, lse, do, p,
                                           seed + 17, index)
    btol, brtol = BWD_TOLERANCE[name]
    bwd = {"phase": "kernel_check", "kernel": "flash_bwd", **labels,
           "shape_bhsd": list(q.shape), "dtype": name, "dropout_p": p,
           "atol_of_max": btol, "rtol": brtol}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        lim = btol * w.float().abs().max().item()
        good = bool(((g.float() - w.float()).abs()
                     <= lim + brtol * w.float().abs()).all())
        bwd[f"max_abs_err_{gname}"] = _max_err(g, w)
        bwd[f"max_abs_{gname}"] = w.float().abs().max().item()
        bwd[f"ok_{gname}"] = good
        failed += [] if good else [(gname, labels, tuple(q.shape), name, p)]
    bwd["max_abs_err"] = max(bwd[f"max_abs_err_{g}"] for g in ("dq", "dk", "dv"))
    if bool(dead.any()):
        # a fully masked batch row gets zero gradient
        bwd["masked_row_grad_zero"] = all(bool((g[dead] == 0).all())
                                          for g in got)
        failed += [] if bwd["masked_row_grad_zero"] else [
            ("masked_row", labels, tuple(q.shape), name, p)]
    if name == "bfloat16":
        bwd.update(_bwd_bf16_checks(att, q, k, v, mask, o, lse, do, p,
                                    seed + 17, got, index))
        failed += [] if bwd["bit_equal_on_rerun"] else [
            ("bwd_determinism", labels, tuple(q.shape), p)]
        failed += [] if bwd["ok_prep"] and bwd["ok_post"] else [
            ("bwd_prep_post", labels, tuple(q.shape), p)]
    emit(bwd)
    return fwd, bwd, failed


def phase_kernel_check(seed: int, errs: dict):
    """Forward and backward kernels against the plain versions at every
    shape, dtype and dropout rate, and at the multimodal path's attention
    calls in the layout the path gives them."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    failed = []
    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for p in (0.0, DROPOUT_P):
                q, k, v, mask = make_attention_inputs(shape, dtype, seed)
                fwd, bwd, bad = _attention_check(att, q, k, v, mask, p, seed,
                                                 {})
                failed += bad
                if shape == TRAIN_SHAPE and dtype == torch.bfloat16 and p > 0:
                    errs["flash_fwd"] = fwd["max_abs_err"]
                    errs["flash_bwd"] = bwd["max_abs_err"]
                    errs["flash_bwd_dq"] = bwd["max_abs_err_dq"]
                    errs["flash_bwd_dkv"] = max(bwd["max_abs_err_dk"],
                                                bwd["max_abs_err_dv"])
                    errs["flash_bwd_prep"] = bwd["max_abs_err_delta"]
                    errs["flash_bwd_post"] = bwd["max_abs_err_post"]
                if shape == D128_SHAPE and dtype == torch.bfloat16 and p > 0:
                    errs["flash_fwd@d128"] = fwd["max_abs_err"]
                    errs["flash_bwd@d128"] = bwd["max_abs_err"]
    failed += _long_sequence_check(seed)
    for name, p in MM_KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = make_path_attention_inputs(name, dtype, seed)
            fwd, bwd, bad = _attention_check(
                att, q, k, v, mask, p, seed, {"path_call": name},
                backward=name not in EVAL_ONLY, index=MM_INDEX.get(name))
            failed += bad
            # the kernels line's rows: each call's bf16 case at its own
            # dropout rate (the calls of a train step: 0.1)
            if dtype == torch.bfloat16 and (p > 0
                                            or name not in PATH_DROPOUT):
                errs[f"flash_fwd@{name}"] = fwd["max_abs_err"]
                if bwd is not None:
                    errs[f"flash_bwd@{name}"] = bwd["max_abs_err"]
    failed += _ring_block_check(seed, errs)
    failed += _gelu_check(seed, errs)
    failed += _layer_norm_check(seed, errs)
    if failed:
        raise AssertionError(f"kernels disagree with the plain versions: "
                             f"{failed}")


def _long_sequence_check(seed: int):
    """LONG_SHAPES, f32 and bf16, p = 0.1 and 0: q, k and v of std 1, the
    last quarter of the keys masked, against the plain versions taken by
    rows; O's atol scaled to max|O| (outputs ~1e-2). Each bf16 backward
    row names the main kernel's grid and the accumulator groups of a head
    (more than one when its q tiles outnumber the grid), and is bit-equal
    on rerun (`_bwd_bf16_checks`)."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    failed = []
    for shape in LONG_SHAPES:
        b, h, s, d = shape
        lanes = att.main_kernel_lanes(d, "cuda")
        labels = {"case": "q tiles past the main kernel's lanes",
                  "main_kernel_lanes": lanes,
                  "q_tiles_a_head": -(-s // 64),
                  "accumulator_groups": att.bwd_groups(-(-s // 64), lanes)}
        for dtype in (torch.float32, torch.bfloat16):
            for p in (0.0, DROPOUT_P):
                gen = torch.Generator(device="cpu").manual_seed(seed)
                q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
                           for _ in range(3))
                mask = torch.ones((b, s), dtype=torch.int32, device="cuda")
                mask[:, (3 * s) // 4:] = 0
                _, _, bad = _attention_check(att, q, k, v, mask, p, seed,
                                             labels, o_scaled=True,
                                             by_rows=True)
                failed += bad
                del q, k, v
                torch.cuda.empty_cache()
    return failed


def make_ring_inputs(dtype, seed: int, shape=None):
    """q, k, v (scaled by 0.5) on the card and the (B, S) key mask of the
    ring attention check (`RING_SHAPE`): every row's last 20 % of keys
    masked, the last row's last 60 % (at a ring of 4 its last two blocks
    have no live key), as the CPU tests' inputs."""
    import torch
    b, h, s, d = shape or RING_SHAPE
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = ((torch.randn((b, h, s, d), generator=gen) * 0.5).to(
        "cuda", dtype) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[:, int(0.8 * s):] = 0
    mask[-1, int(0.4 * s):] = 0
    return q, k, v, mask.cuda()


def ring_block(x, j, n):
    """Block j (of n rows) of a (B, H, S, D) tensor's sequence (a view)."""
    return x[:, :, j * n:(j + 1) * n]


def _ring_block_check(seed: int, errs: dict):
    """A ring attention block (`RING_SHAPE` on `RING_SIZE` positions,
    bf16): position 1's queries against block 2's keys and values (the
    last row's keys there all masked), the forward at the block, and the
    backward's main kernel under the global (o, lse) of the whole
    sequence, as ring attention's backward runs it (pre-pass, main kernel,
    post-pass on one block), against the plain versions; O's atol scaled
    to max|O| (the inputs' outputs are ~1e-2)."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    q, k, v, mask = make_ring_inputs(torch.bfloat16, seed)
    b, h, s, _ = q.shape
    n = s // RING_SIZE
    i, r = 1, 2
    qi, kr, vr = ring_block(q, i, n), ring_block(k, r, n), ring_block(v, r, n)
    mr = mask[:, r * n:(r + 1) * n]
    labels = {"path_call": "ring_block", "block_q": i, "block_kv": r}
    fwd, _, failed = _attention_check(att, qi, kr, vr, mr, 0.0, seed, labels,
                                      backward=False, o_scaled=True)
    o, lse = att.attention_reference_lse(q, k, v, mask)
    oi = ring_block(o, i, n).contiguous()
    lse_i = lse.view(b, h, s)[:, :, i * n:(i + 1) * n].reshape(b * h, n)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.randn(qi.shape, generator=gen).to("cuda", torch.bfloat16)
    delta, lse2, acc, turns = att.flash_bwd_prep(oi, do, lse_i.contiguous())
    dk, dv = att.flash_bwd_main(qi, kr, vr, mr, lse2, delta, acc, turns, do)
    got = (att.flash_bwd_post(acc, qi), dk, dv)
    torch.cuda.synchronize()
    want = att.attention_bwd_reference(qi, kr, vr, mr, oi, lse_i, do)
    btol, brtol = BWD_TOLERANCE["bfloat16"]
    row = {"phase": "kernel_check", "kernel": "flash_bwd", **labels,
           "case": "main kernel under the global lse",
           "shape_bhsd": list(qi.shape), "dtype": "bfloat16",
           "atol_of_max": btol, "rtol": brtol}
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        lim = btol * w.float().abs().max().item()
        good = bool(((g.float() - w.float()).abs()
                     <= lim + brtol * w.float().abs()).all())
        row[f"max_abs_err_{gname}"] = _max_err(g, w)
        row[f"max_abs_{gname}"] = w.float().abs().max().item()
        row[f"ok_{gname}"] = good
        failed += [] if good else [(gname, labels)]
    # the masked keys of the block get zero dk and dv
    dead = ~mr.bool()
    row["masked_keys_grad_zero"] = all(
        bool((g.transpose(1, 2)[dead] == 0).all()) for g in (dk, dv))
    failed += [] if row["masked_keys_grad_zero"] else [("masked_keys",
                                                        labels)]
    row["max_abs_err"] = max(row[f"max_abs_err_{g}"] for g in ("dq", "dk",
                                                             "dv"))
    emit(row)
    errs["flash_fwd@ring_block"] = fwd["max_abs_err"]
    errs["flash_bwd@ring_block"] = row["max_abs_err"]
    return failed


def fwd_reference_by_rows(att, q, k, v, mask, p, seed, index=None,
                          rows=REFERENCE_ROWS):
    """`attention_reference_lse` taken `rows` q rows at a time, for lengths
    whose (S, S) score matrices do not fit on the card whole: the same
    formulas (f32 logits, the mask by `where`, softmax, the keep bits of
    each row, probabilities cast to the input dtype before P.V)."""
    import torch
    b, h, s, d = q.shape
    keep = mask.bool()[:, None, None, :]
    seeds = att._seed_for_bh(seed, att.global_bh(b, h, index, q.device))
    cols = torch.arange(s, dtype=torch.int64, device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        logits = torch.einsum("bhsd,bhtd->bhst", q[:, :, r0:r1].float(),
                              k.float()) * (1.0 / math.sqrt(d))
        logits = logits.masked_fill(~keep, att.NEG_INF)
        lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        del logits
        if p > 0:
            bits = att._keep_bits(seeds.view(b, h, 1, 1), cols[r0:r1], cols,
                                  s, att.keep_threshold(p))
            probs = torch.where(bits, probs / (1.0 - p), 0.0)
            del bits
        o[:, :, r0:r1] = torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)
        del probs
    return o, lse.reshape(b * h, s)


def bwd_reference_by_rows(att, q, k, v, mask, o, lse, do, p, seed,
                          index=None, rows=REFERENCE_ROWS):
    """`attention_bwd_reference` taken `rows` q rows at a time, for lengths
    whose (S, S) score matrices do not fit on the card whole: the same
    formulas in f32 (p, the keep bits of each row, dp, ds), dq row by row
    and dk, dv summed over the row chunks in f32, each cast to the input
    dtype at the end."""
    import torch
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = att.attention_delta(o, do).view(b, h, s, 1)
    keep = mask.bool()[:, None, None, :]
    seeds = att._seed_for_bh(seed, att.global_bh(b, h, index, q.device))
    seeds = seeds.view(b, h, 1, 1)
    cols = torch.arange(s, dtype=torch.int64, device=q.device)
    thresh = att.keep_threshold(p) if p > 0 else 0
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = scale * torch.einsum("bhsd,bhtd->bhst", qf[:, :, r0:r1], kf)
        pr = torch.where(keep, torch.exp(
            sc - lse.view(b, h, s, 1)[:, :, r0:r1]), 0.0)
        del sc
        dp = torch.einsum("bhsd,bhtd->bhst", dof[:, :, r0:r1], vf)
        p_ctx = pr
        if p > 0:
            bits = att._keep_bits(seeds, cols[r0:r1], cols, s, thresh)
            dp = torch.where(bits, dp / (1.0 - p), 0.0)
            p_ctx = torch.where(bits, pr / (1.0 - p), 0.0)
            del bits
        ds = pr * (dp - delta[:, :, r0:r1])
        del dp
        dq[:, :, r0:r1] = scale * torch.einsum("bhst,bhtd->bhsd", ds, kf)
        dk += scale * torch.einsum("bhst,bhsd->bhtd", ds, qf[:, :, r0:r1])
        dv += torch.einsum("bhst,bhsd->bhtd", p_ctx, dof[:, :, r0:r1])
        del ds, pr, p_ctx
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The bf16 backward's pre-pass against `attention_delta`: f32 sums of the
# same products in another order, |err| <= 1e-5 * (1 + |delta|); lse2 is
# the same f32 product in both (relative 1e-6 allows for the rounding of
# log2(e) to f32 in one of them). The post-pass: the same f32 product and
# bf16 rounding in both, so bit-equal.
PREP_TOLERANCE = 1e-5


def _bwd_bf16_checks(att, q, k, v, mask, o, lse, do, p, seed, got,
                     index=None):
    """The bf16 backward's pre-pass and post-pass against their plain
    versions (the pre-pass also zeroes every accumulator slice and turn
    counter; the post-pass sums the slices), and a rerun on equal inputs:
    dq, dk and dv must be bit-equal (fixed orders of sums; dq's partials
    are reduce-added in turn), and dq's largest difference is reported."""
    import torch
    delta, lse2, acc, turns = att.flash_bwd_prep(o, do, lse)
    want_delta, want_lse2, _ = att.attention_bwd_prep_reference(o, do, lse)
    err_delta = (delta - want_delta).abs()
    ok_prep = (bool((err_delta <= PREP_TOLERANCE * (1 + want_delta.abs())).all())
               and bool(torch.isclose(lse2, want_lse2, rtol=1e-6, atol=0).all())
               and not bool(acc.any()) and not bool(turns.any()))
    acc.normal_()
    dq = att.flash_bwd_post(acc, q)
    want_dq = att.attention_bwd_post_reference(acc, q)
    again = att.flash_attention_bwd(q, k, v, mask, o, lse, do, p, seed,
                                    index)
    return {"max_abs_err_delta": err_delta.max().item(), "ok_prep": ok_prep,
            "accumulator_groups": acc.shape[1] // (-(-q.shape[2] // 64) * 64),
            "max_abs_err_post": _max_err(dq, want_dq),
            "ok_post": torch.equal(dq, want_dq),
            "bit_equal_on_rerun": all(torch.equal(a, g)
                                      for a, g in zip(again, got)),
            "dq_rerun_max_abs_diff": _max_err(again[0], got[0])}


def _layer_norm_inputs(rows, n, mean, offset, constant, dtype, seed):
    """x (rows of std 1 around `mean`, or of one value each, at a storage
    offset of `offset` elements), dy, w and b on the card."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if constant:  # k / 32 for k in [64, 128): 7 significant bits
        k = torch.randint(64, 128, (rows, 1), generator=gen)
        x = (mean - 3.0 + k / 32.0).expand(rows, n)
    else:
        x = torch.randn(rows, n, generator=gen) + mean
    flat = torch.empty(rows * n + offset, device="cuda", dtype=dtype)
    flat[offset:] = x.reshape(-1).to("cuda", dtype)
    x = flat[offset:].view(rows, n)
    dy = torch.randn(rows, n, generator=gen).to("cuda", dtype)
    w = (1 + 0.1 * torch.randn(n, generator=gen)).cuda()
    b = (0.1 * torch.randn(n, generator=gen)).cuda()
    return x, dy, w, b


def _layer_norm_check(seed: int, errs: dict):
    """The LayerNorm kernels against autograd of the plain version at
    LN_SHAPES and LN_EDGE_CASES, in both dtypes (bf16: with the count of
    outputs one ulp from the plain version's); a rerun of the backward is
    bit-equal; and the two kernels share their row statistics."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    failed = []
    cases = [(rows, n, mean, 0, False) for rows, n, mean in LN_SHAPES]
    for rows, n, mean, offset, constant in cases + LN_EDGE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, dy, w, b = _layer_norm_inputs(rows, n, mean, offset, constant,
                                             dtype, seed)
            y = ln.layer_norm_fwd(x, w, b, 1e-5)
            dx, dw, db = ln.layer_norm_bwd(x, dy, w, 1e-5)
            again = ln.layer_norm_bwd(x, dy, w, 1e-5)
            xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
            yr = ln.layer_norm_reference(xr, wr, br, 1e-5, dtype)
            yr.backward(dy)
            atol, rtol = LN_TOLERANCE[name]
            row = {"phase": "kernel_check", "kernel": "layer_norm",
                   "shape": [rows, n], "mean": mean, "x_offset": offset,
                   "constant_rows": constant, "dtype": name,
                   "atol": atol, "rtol": rtol}
            if constant:  # the plain version's variance: 0 in every row
                xf = x.float()
                var = (xf * xf).mean(-1) - xf.mean(-1) ** 2
                row["rows_of_zero_variance_in_plain"] = int((var == 0).sum().item())
                row["y_equals_b"] = bool(torch.equal(
                    y.float(), b.to(dtype).float().expand(rows, n)))
                failed += [] if row["y_equals_b"] else [
                    ("layer_norm_constant_rows", n, name)]
            for kname, got, want in (("y", y, yr), ("dx", dx, xr.grad),
                                     ("dw", dw, wr.grad), ("db", db, br.grad)):
                want = want.detach()
                err = (got.float() - want.float()).abs()
                lim = atol * (want.float().abs().max().item()
                              if kname in ("dw", "db") else 1.0)
                ok = bool((err <= lim + rtol * want.float().abs()).all())
                row[f"max_abs_err_{kname}"] = err.max().item()
                row[f"ok_{kname}"] = ok
                failed += [] if ok else [(f"layer_norm_{kname}", rows, n,
                                          offset, constant, name)]
                if dtype == torch.bfloat16 and kname in ("y", "dx"):
                    ulp = (_bf16_order(got) - _bf16_order(want.to(dtype))).abs()
                    row[f"one_ulp_flips_{kname}"] = int((ulp == 1).sum().item())
                    row[f"over_one_ulp_{kname}"] = int((ulp > 1).sum().item())
            # dw and db are summed in a fixed order: a rerun is bit-equal
            row["dx_dw_db_bit_equal_on_rerun"] = all(
                torch.equal(a, b) for a, b in zip(again, (dx, dw, db)))
            if not row["dx_dw_db_bit_equal_on_rerun"]:
                failed.append(("layer_norm_bwd_determinism", rows, n, name))
            emit(row)
            if not (offset or constant or mean) and rows == 8 * VB_S:
                tag = "vb" if name == "bfloat16" else "vb_f32"
                errs[f"layer_norm_fwd@{tag}"] = row["max_abs_err_y"]
                errs[f"layer_norm_bwd@{tag}"] = row["max_abs_err_dx"]
            if offset or constant or mean != 0.0 or name != "bfloat16":
                continue
            if rows == LN_SHAPES[1][0]:
                errs["layer_norm_fwd"] = row["max_abs_err_y"]
                errs["layer_norm_bwd"] = row["max_abs_err_dx"]
            if (rows, n) == (RQ_ROWS, 768):
                errs["layer_norm_fwd@bert_base"] = row["max_abs_err_y"]
                errs["layer_norm_bwd@bert_base"] = row["max_abs_err_dx"]
            if (rows, n) == (SP_ROWS, 1024):
                errs["layer_norm_fwd@sp"] = row["max_abs_err_y"]
                errs["layer_norm_bwd@sp"] = row["max_abs_err_dx"]
            if rows == LN_SHAPES[0][0]:
                errs["layer_norm_fwd@eval"] = row["max_abs_err_y"]
    failed += _layer_norm_shared_stats(seed)
    return failed


def _layer_norm_shared_stats(seed: int):
    """The forward and the backward compute each row's mean and rstd by one
    routine, so the backward recomputes the forward's statistics bit for
    bit. Neither returns them, so: (1) a forward/backward pair at the eval
    shape in bf16 is bit-equal on a rerun; (2) in f32 with w = 1 and b = 0
    the forward gives y = (x - mean) * rstd, rounded once, and the
    backward's dw over a dy that is 1 on row r and 0 elsewhere is that
    row's (x - mean) * rstd, rounded once and then added to zeros only: the
    two are bit-equal exactly when both kernels saw the same mean and rstd.
    Both on the vector path and (x at an odd storage offset) the scalar
    path."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    rows, n, _ = LN_SHAPES[0]
    failed = []
    x, dy, w, b = _layer_norm_inputs(rows, n, 0.0, 0, False, torch.bfloat16, seed)
    first = (ln.layer_norm_fwd(x, w, b, 1e-5), *ln.layer_norm_bwd(x, dy, w, 1e-5))
    again = (ln.layer_norm_fwd(x, w, b, 1e-5), *ln.layer_norm_bwd(x, dy, w, 1e-5))
    rerun = all(torch.equal(a, c) for a, c in zip(first, again))
    row = {"phase": "kernel_check", "kernel": "layer_norm",
           "case": "shared statistics", "shape": [rows, n],
           "fwd_bwd_bit_equal_on_rerun_bf16": rerun}
    failed += [] if rerun else [("layer_norm_fwd_bwd_rerun", rows)]
    one, zero = torch.ones(n, device="cuda"), torch.zeros(n, device="cuda")
    for offset in (0, 1):
        x, _, _, _ = _layer_norm_inputs(rows, n, 0.5, offset, False,
                                        torch.float32, seed + 1)
        y = ln.layer_norm_fwd(x, one, zero, 1e-5)
        equal = []
        for r in LN_STATS_ROWS:
            dy = torch.zeros(rows, n, device="cuda")
            dy[r] = 1.0
            dw = ln.layer_norm_bwd(x, dy, one, 1e-5)[1]
            equal.append(torch.equal(dw, y[r]))
        row[f"stats_bit_equal_rows_offset_{offset}"] = equal
        failed += [] if all(equal) else [("layer_norm_shared_stats", offset)]
    emit(row)
    return failed


def _gelu_check(seed: int, errs: dict):
    """The GELU kernels against their plain versions: on inputs spanning
    the clip range and its tails at the main paths' shapes; on every finite
    bf16 value (forward, backward with g = 1 and with a random g); and at
    the lengths and offsets of GELU_EDGE_CASES. Both dtypes."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.ops import gelu as gl
    failed = []
    for shape in GELU_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cpu").manual_seed(seed)
            x = (torch.randn(shape, generator=gen) * 6).to("cuda", dtype)
            g = torch.randn(shape, generator=gen).to("cuda", dtype)
            atol, rtol = GELU_TOLERANCE[name]
            row = {"phase": "kernel_check", "kernel": "gelu_logit_erf",
                   "shape": list(shape), "dtype": name, "atol": atol,
                   "rtol": rtol}
            for kname, got, want in (
                    ("fwd", gl.gelu_logit_erf_fwd(x),
                     gl.gelu_logit_erf_reference(x)),
                    ("bwd", gl.gelu_logit_erf_bwd(x, g),
                     gl.gelu_logit_erf_bwd_reference(x, g))):
                err = (got.float() - want.float()).abs()
                ok = bool((err <= atol + rtol * want.float().abs()).all())
                row[f"max_abs_err_{kname}"] = err.max().item()
                row[f"ok_{kname}"] = ok
                failed += [] if ok else [(f"gelu_{kname}", shape, name)]
                if name == "bfloat16" and shape == GELU_SHAPES[1]:
                    errs[f"gelu_logit_erf_{kname}"] = err.max().item()
                if name == "bfloat16" and shape == GELU_SHAPES[-1]:
                    errs[f"gelu_logit_erf_{kname}@bert_base"] = err.max().item()
                if name == "bfloat16" and shape == (8 * VB_S, 4096):
                    errs[f"gelu_logit_erf_{kname}@vb"] = err.max().item()
                if name == "bfloat16" and shape == (PP_ROWS, 4096):
                    errs[f"gelu_logit_erf_{kname}@pp"] = err.max().item()
                if name == "bfloat16" and shape == GELU_SHAPES[0] and kname == "fwd":
                    errs["gelu_logit_erf_fwd@eval"] = err.max().item()
            emit(row)
    f32 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    every_bf16 = torch.from_numpy(f32[np.isfinite(f32)].copy())
    gen = torch.Generator(device="cpu").manual_seed(seed + 3)
    random_g = torch.randn(every_bf16.shape, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x = every_bf16.to("cuda", dtype)
        row = {"phase": "kernel_check", "kernel": "gelu_logit_erf",
               "case": "every finite bf16 value", "n": x.numel(),
               "dtype": name}
        for label, g in (("bwd_g1", torch.ones_like(x)),
                         ("bwd_random_g", random_g.to("cuda", dtype)),
                         ("fwd", None)):
            got = (gl.gelu_logit_erf_fwd(x) if g is None
                   else gl.gelu_logit_erf_bwd(x, g))
            want = (gl.gelu_logit_erf_reference(x) if g is None
                    else gl.gelu_logit_erf_bwd_reference(x, g))
            row[label] = _gelu_agree(got, want)
            failed += [] if row[label]["ok"] else [(f"gelu_{label}", "every", name)]
        emit(row)
    for n, x_off, g_off in GELU_EDGE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cpu").manual_seed(seed + n)
            x = (torch.randn(n + x_off, generator=gen) * 6).to("cuda", dtype)[x_off:]
            g = torch.randn(n + g_off, generator=gen).to("cuda", dtype)[g_off:]
            row = {"phase": "kernel_check", "kernel": "gelu_logit_erf",
                   "case": "edge", "n": n, "x_offset": x_off,
                   "g_offset": g_off, "dtype": name,
                   "fwd": _gelu_agree(gl.gelu_logit_erf_fwd(x),
                                      gl.gelu_logit_erf_reference(x)),
                   "bwd": _gelu_agree(gl.gelu_logit_erf_bwd(x, g),
                                      gl.gelu_logit_erf_bwd_reference(x, g))}
            emit(row)
            failed += [(f"gelu_{k}", n, x_off, g_off, name)
                       for k in ("fwd", "bwd") if not row[k]["ok"]]
    return failed


def _bf16_order(t):
    """bf16 bit patterns as integers ordered like the values they encode,
    so a difference of 1 is one ulp (also across zero)."""
    import torch
    b = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(b >= 0x8000, -(b & 0x7FFF), b)


def _gelu_agree(got, want) -> dict:
    """f32: within GELU_TOLERANCE. bf16: at most one ulp apart, or less
    than 1e-30 apart (the rule of tests/test_torch_models.py); with the
    count of one-ulp flips and of differences that only the 1e-30 clause
    allows."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    out = {"max_abs_err": err.max().item()}
    if got.dtype == torch.float32:
        atol, rtol = GELU_TOLERANCE["float32"]
        out["ok"] = bool((err <= atol + rtol * want.float().abs()).all())
        return out
    ulp = (_bf16_order(got) - _bf16_order(want)).abs()
    tiny = err < 1e-30
    out.update(ok=bool(((ulp <= 1) | tiny).all()),
               one_ulp_flips=int((ulp == 1).sum().item()),
               bit_equal=int((ulp == 0).sum().item()),
               below_1e30_only=int(((ulp > 1) & tiny).sum().item()))
    return out


def phase_bits_check(seed: int, errs: dict):
    """Both dump orders, which replay the bf16 kernels' fragment maps
    (`keep_bits_dump.cu`), equal to the plain bits, with the keep rate
    within 0.005 of 1 - p; the dumped-bits check of
    tools/verify_dropout_bits."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.tools import verify_dropout_bits
    b, h, s, _ = TRAIN_SHAPE
    # the train shape, a long row, the verify script's shape, more
    # batch*heads than a grid's y takes, and ragged lengths (S % 64 != 0,
    # S % 16 != 0: the narrower stores) of the paths' calls: BERSON's pool
    # and joint pairs, the multimodal joint stream, at a few heads (over
    # 70,000 elements each, so that the keep rate is ~5 sigma within its
    # limit). Every head width's kernels share the maps the dump replays
    # (keep_bits.cuh), so the D = 128 instances need no shape of their own.
    for bs, hs, ss in ((b, h, s), (1, 1, 1024), (2, 3, 256), (4097, 16, 16),
                       (4, 4, 70), (2, 4, 99), (1, 2, 219), (1, 1, 566)):
        fwd = att.dump_keep_bits("fwd", seed, bs, hs, ss, DROPOUT_P)
        dkv = att.dump_keep_bits("dkv", seed, bs, hs, ss, DROPOUT_P)
        plain = att.keep_bits(seed, bs, hs, ss, DROPOUT_P, "cuda")
        mism = int((fwd != plain).sum().item() + (dkv != plain).sum().item())
        keep = fwd.float().mean().item()
        ok = mism == 0 and abs(keep - (1 - DROPOUT_P)) <= 0.005
        emit({"phase": "bits_check", "shape_bhs": [bs, hs, ss],
              "mismatches": mism, "keep_rate": keep, "ok": ok})
        if not ok:
            raise AssertionError(f"keep bits at {(bs, hs, ss)}")
        if (bs, hs, ss) in ((b, h, s), (2, 3, 256)):
            errs["keep_bits_dump" if ss == s else "keep_bits_dump@verify"] = float(mism)
    # a data- and tensor-parallel rank's slice: the heads at a non-zero
    # batch and head offset draw the whole batch's bits of those heads
    for bs, hs, index in ((4, 8, (4, 8, 16)), (3, 2, (5, 1, 3))):
        fwd = att.dump_keep_bits("fwd", seed, bs, hs, s, DROPOUT_P,
                                 index=index)
        dkv = att.dump_keep_bits("dkv", seed, bs, hs, s, DROPOUT_P,
                                 index=index)
        plain = att.keep_bits(seed, bs, hs, s, DROPOUT_P, "cuda", index)
        b_off, h_off, h_tot = index
        whole = att.keep_bits(seed, b_off + bs, h_tot, s, DROPOUT_P, "cuda")[
            b_off:, h_off:h_off + hs]
        mism = int((fwd != plain).sum().item() + (dkv != plain).sum().item()
                   + (plain != whole).sum().item())
        emit({"phase": "bits_check", "shape_bhs": [bs, hs, s],
              "global_bh_index": list(index), "mismatches": mism,
              "ok": mism == 0})
        if mism:
            raise AssertionError(f"keep bits at global index {index}")
    res = verify_dropout_bits.verify(device="cuda")
    emit({"phase": "bits_check", "verify_dropout_bits": res})


def sass_loop_bodies(lib: str, wanted, marker: str) -> dict:
    """{function name: opcodes of its loop body} for each kernel of the
    built library `lib` (`cuobjdump -sass`, from the toolkit beside `nvcc`)
    whose mangled name `wanted` accepts: the body of the backward branch
    that holds the most instructions whose opcode starts with `marker` (the
    shortest among equals)."""
    import re
    from multimodal_sequencing_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split()[0]
        if not wanted(name):
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
            fn)]
        best = None  # (marker count, opcodes of the loop body)
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if not op.startswith("BRA") or not target:
                continue
            start = int(target.group(1), 16)
            if start >= addr:
                continue
            body = [o for a, o, _ in ins if start <= a <= addr]
            n = sum(o.startswith(marker) for o in body)
            if n and (best is None or (n, -len(body)) > (best[0], -len(best[1]))):
                best = (n, body)
        if best is not None:
            out[name] = best[1]
    return out


def gelu_sass_per_element() -> dict:
    """SASS instructions an element of the bf16 GELU kernels' vector loop:
    the loop is the backward branch whose body holds the most MUFU.EX2,
    which each element takes once. Returns, for "fwd" and "bwd", the
    elements a turn and the FP32-pipe, MUFU, other and total instructions
    an element."""
    out = {}
    for name, body in sass_loop_bodies(
            "gelu", lambda n: "gelu_kernel" in n and "bfloat16" in n,
            "MUFU.EX2").items():
        ex2 = body.count("MUFU.EX2")
        ops = [o.split(".")[0] for o in body]
        fp32 = sum(o in FP32_PIPE for o in ops)
        mufu = ops.count("MUFU")
        out["bwd" if "Lb1E" in name else "fwd"] = {
            "elements_per_turn": ex2, "fp32": fp32 / ex2, "mufu": mufu / ex2,
            "other": (len(ops) - fp32 - mufu) / ex2, "total": len(ops) / ex2}
    return out


def dump_sass_per_element() -> dict:
    """SASS instructions an element of the keep-bit dump kernels' tile loop
    (its 16-byte-store instances; the loop holds the `stmatrix`, STSM): a
    turn is one 64 x 64 tile, 32 elements a thread. Returns, for "fwd" and
    "dkv", the integer ALU instructions (the pipe the compiled loop waits
    on), IMAD and VIADD apart, the memory and barrier ones, the rest and
    the total an element."""
    out = {}
    for name, body in sass_loop_bodies(
            "keep_bits_dump", lambda n: "dump_" in n and "ILi16E" in n,
            "STSM").items():
        ops = [o.split(".")[0] for o in body]
        n = 64 * 64 // 128
        counts = {"alu": sum(o in INT_ALU for o in ops),
                  "imad": ops.count("IMAD"), "viadd": ops.count("VIADD"),
                  "memory_and_barrier": sum(
                      o in ("STSM", "LDS", "STG", "BAR") for o in ops)}
        counts["other"] = len(ops) - sum(counts.values())
        out["dkv" if "dkv" in name else "fwd"] = {
            "elements_per_turn": n, "total": len(ops) / n,
            **{k: v / n for k, v in counts.items()}}
    return out


def _gelu_timing(gen) -> dict:
    """The bf16 GELU kernels at the train MLP shape and the RecipeQA
    launcher's bert-base rows (forward and backward) and the eval shape
    (forward), against their plain versions and PyTorch's
    exact-erf GELU. The bound is the larger of the bytes at the published
    rate and the instruction floor: the vector loop's SASS FP32-pipe
    instructions at 128 lanes and its MUFU operations at 16 an SM a clock,
    at the card's SM count and maximum SM clock read in the run."""
    import torch
    import torch.nn.functional as F
    from multimodal_sequencing_tpu_torch.ops import gelu as gl
    from multimodal_sequencing_tpu_torch.tools.host_cost import host_us
    try:
        sass = gelu_sass_per_element()
    except (OSError, subprocess.SubprocessError) as e:
        sass = {"error": repr(e)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    rows = {}

    def row(kind, n, tensors, kernel, plain, library):
        per = sass.get(kind)
        out = {"ms": kernel_ms(kernel), "plain_ms": kernel_ms(plain, iters=10),
               "library_ms": kernel_ms(library),
               "host_us_per_call": host_us(kernel),
               "sass_per_element": per, "sm_clock_hz": clock}
        t_bytes = tensors * n * 2 / PEAK_BYTES_PER_S * 1e3
        t_ops = 0.0
        if per:
            out["fp32_floor_ms"] = (per["fp32"] * n / (
                LANES_PER_SM_CLOCK * sms * clock) * 1e3)
            out["mufu_floor_ms"] = (per["mufu"] * n / (
                MUFU_PER_SM_CLOCK * sms * clock) * 1e3)
            # every instruction takes an issue slot: 4 schedulers of 32 lanes
            out["issue_floor_ms"] = (per["total"] * n / (
                LANES_PER_SM_CLOCK * sms * clock) * 1e3)
            t_ops = max(out["fp32_floor_ms"], out["mufu_floor_ms"])
        out.update(bytes=tensors * n * 2, bytes_ms=t_bytes,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        return out

    for name, shape in (("gelu_logit_erf_fwd", GELU_SHAPES[1]),
                        ("gelu_logit_erf_fwd@eval", GELU_SHAPES[0]),
                        ("gelu_logit_erf_fwd@bert_base", GELU_SHAPES[-1]),
                        ("gelu_logit_erf_fwd@vb", (8 * VB_S, 4096)),
                        ("gelu_logit_erf_fwd@pp", (PP_ROWS, 4096))):
        x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16) * 3
        rows[name] = {"shape": list(shape), **row(
            "fwd", x.numel(), 2, lambda: gl.gelu_logit_erf_fwd(x),
            lambda: gl.gelu_logit_erf_reference(x), lambda: F.gelu(x))}
        if name != "gelu_logit_erf_fwd@eval":
            g = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
            rows[name.replace("fwd", "bwd")] = {"shape": list(shape), **row(
                "bwd", x.numel(), 3, lambda: gl.gelu_logit_erf_bwd(x, g),
                lambda: gl.gelu_logit_erf_bwd_reference(x, g),
                lambda: torch.ops.aten.gelu_backward(g, x))}
        del x
    return rows


def phase_timing(seed: int):
    """Kernels, plain versions and library yardsticks at the train shape
    (bf16, dropout 0.1; the flash, GELU and LayerNorm forwards also at the
    eval shape, the flash forward there without dropout)."""
    import torch
    import torch.nn.functional as F
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.tools.host_cost import host_us
    rows = {}

    def inputs(shape, lo):
        q, k, v, _ = make_attention_inputs(shape, torch.bfloat16, seed)
        b, _, s, _ = shape
        # packed stories fill most of S: keep lo..S keys per row
        gen = torch.Generator(device="cpu").manual_seed(seed + 1)
        lengths = torch.randint(lo, s + 1, (b,), generator=gen)
        mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
        return q, k, v, mask.cuda()

    def fwd_row(q, k, v, mask, p, sd, plain_iters=30):
        """The bf16 forward against SDPA on the same inputs."""
        bool_mask = mask.bool()[:, None, None, :]
        b, h, s, d = q.shape
        ms = kernel_ms(lambda: att.flash_attention(q, k, v, mask, p, sd))
        lib = kernel_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bool_mask, dropout_p=p))
        return {"ms": ms, "library_ms": lib, "library_ratio": ms / lib,
                "host_us_per_call": host_us(
                    lambda: att.flash_attention(q, k, v, mask, p, sd)),
                "plain_ms": kernel_ms(lambda: att.attention_reference_lse(
                    q, k, v, mask, p, sd), iters=plain_iters),
                **bound(4 * b * h * s * d * 2 + b * h * s * 4 + b * s * 4,
                        4 * b * h * s * s * d)}

    q, k, v, mask = inputs(EVAL_SHAPE, 260)
    emit({"phase": "timing", "kernel": "flash_fwd", "shape_bhsd": list(EVAL_SHAPE),
          "dropout_p": 0.0, **fwd_row(q, k, v, mask, 0.0, 0)})

    b, h, s, d = TRAIN_SHAPE
    bhsd, bhs = b * h * s * d, b * h * s
    q, k, v, mask = inputs(TRAIN_SHAPE, 260)
    bool_mask = mask.bool()[:, None, None, :]
    sd = seed + 5
    o, lse = att.flash_attention(q, k, v, mask, DROPOUT_P, sd)
    gen = torch.Generator(device="cpu").manual_seed(seed + 2)
    do = torch.randn(TRAIN_SHAPE, generator=gen).to("cuda", torch.bfloat16)
    plain_bwd_ms = kernel_ms(lambda: att.attention_bwd_reference(
        q, k, v, mask, o, lse, do, DROPOUT_P, sd), iters=10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bool_mask,
                                         dropout_p=DROPOUT_P)
    lib_bwd_ms = kernel_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    int_ops_per_s = (INT_OPS_PER_SM_CLOCK * max_sm_clock_hz()
                     * torch.cuda.get_device_properties(0).multi_processor_count)
    rows["flash_fwd"] = {
        **fwd_row(q, k, v, mask, DROPOUT_P, sd, plain_iters=10),
        "hash_floor_ms_estimate": HASH_OPS_PER_ELEMENT * b * h * s * s
        / int_ops_per_s * 1e3, "int_ops_per_s": int_ops_per_s}
    # the bf16 backward: the whole (pre-pass, main, post-pass) against its
    # bound and SDPA's backward; the main kernel, which yields dq's partials
    # and dk, dv in one pass, stands for both TPU kernels it replaces
    s_pad = -(-s // 64) * 64
    acc_bytes = b * h * s_pad * d * 4
    prep, lse2_b, acc, turns = att.flash_bwd_prep(o, do, lse)
    bwd_ms = kernel_ms(lambda: att.flash_attention_bwd(
        q, k, v, mask, o, lse, do, DROPOUT_P, sd))
    main_ms = kernel_ms(lambda: att.flash_bwd_main(
        q, k, v, mask, lse2_b, prep, acc, turns, do, DROPOUT_P, sd))
    rows["flash_bwd"] = {
        "ms": bwd_ms, "main_ms": main_ms, "plain_ms": plain_bwd_ms,
        "library_ms": lib_bwd_ms, "library_ratio": bwd_ms / lib_bwd_ms,
        **bound(8 * bhsd * 2 + bhs * 4 + b * s * 4, 5 * 2 * b * h * s * s * d)}
    # The bounds count what each function needs, not the design's f32 dq
    # accumulator (`acc_bytes`: zeroed by the pre-pass, reduce-added into by
    # the main kernel, read by the post-pass), which the rows list apart.
    main_row = {
        "ms": main_ms, "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms,
        "acc_bytes": acc_bytes,
        # reads q, k, v, dO, lse, delta and the mask; writes dq, dk and dv
        **bound(7 * bhsd * 2 + 2 * bhs * 4 + b * s * 4,
                5 * 2 * b * h * s * s * d)}
    rows["flash_bwd_dq"] = dict(main_row)
    rows["flash_bwd_dkv"] = dict(main_row)
    rows["flash_bwd_prep"] = {
        "ms": kernel_ms(lambda: att.flash_bwd_prep(o, do, lse)),
        "plain_ms": kernel_ms(lambda: att.attention_bwd_prep_reference(o, do, lse)),
        "library_ms": None, "acc_bytes": acc_bytes,
        # reads O, dO and lse; writes delta and lse2
        **bound(2 * bhsd * 2 + 3 * bhs * 4, 0)}
    rows["flash_bwd_post"] = {
        "ms": kernel_ms(lambda: att.flash_bwd_post(acc, q)),
        "plain_ms": kernel_ms(lambda: att.attention_bwd_post_reference(acc, q)),
        "library_ms": None, **bound(bhsd * 4 + bhsd * 2, 0)}

    def dump_pair(bs, hs, ss):
        att.dump_keep_bits("fwd", sd, bs, hs, ss, DROPOUT_P)
        att.dump_keep_bits("dkv", sd, bs, hs, ss, DROPOUT_P)

    try:
        dump_sass = dump_sass_per_element()
    except (OSError, subprocess.SubprocessError) as e:
        dump_sass = {"error": repr(e)}
    for name, (bs, hs, ss) in (("keep_bits_dump", (b, h, s)),
                               ("keep_bits_dump@verify", (2, 3, 256))):
        # both orders: one byte written and one hash an element each
        elements = 2 * bs * hs * ss * ss
        rows[name] = {
            "ms": kernel_ms(lambda: dump_pair(bs, hs, ss)),
            "plain_ms": kernel_ms(lambda: att.keep_bits(
                sd, bs, hs, ss, DROPOUT_P, "cuda"), iters=10),
            "library_ms": None, "sass_per_element": dump_sass,
            **int_bound(elements, HASH_OPS_PER_ELEMENT * elements,
                        int_ops_per_s)}
        if "fwd" in dump_sass and "dkv" in dump_sass:
            # the compiled loops' instructions at the issue rate, and their
            # ALU instructions at the ALU pipe's
            per = {k: (dump_sass["fwd"][k] + dump_sass["dkv"][k]) / 2
                   for k in ("total", "alu")}
            rows[name]["sass_issue_floor_ms"] = (
                per["total"] * elements / int_ops_per_s * 1e3)
            rows[name]["sass_alu_floor_ms"] = (
                per["alu"] * elements / int_ops_per_s * 1e3
                * INT_OPS_PER_SM_CLOCK / ALU_LANES_PER_SM_CLOCK)
    rows.update(_gelu_timing(gen))
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    x = torch.randn(b * s, 1024, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(b * s, 1024, generator=gen).to("cuda", torch.bfloat16)
    w = torch.ones(1024, device="cuda")
    bias = torch.zeros(1024, device="cuda")
    nbytes = x.numel() * 2

    def ln_fwd_row(xx):
        nb = xx.numel() * 2
        return {"shape": list(xx.shape),
                "ms": kernel_ms(lambda: ln.layer_norm_fwd(xx, w, bias, 1e-5)),
                "plain_ms": kernel_ms(lambda: ln.layer_norm_reference(
                    xx, w, bias, 1e-5, torch.bfloat16)),
                "library_ms": kernel_ms(lambda: torch.nn.functional.layer_norm(
                    xx, (1024,), w.bfloat16(), bias.bfloat16())),
                "host_us_per_call": host_us(
                    lambda: ln.layer_norm_fwd(xx, w, bias, 1e-5)),
                # reads x, w and b; writes y
                **bound(2 * nb + 2 * 1024 * 4, 0)}

    # what any launch costs in this timing loop: the kernel on one row, and
    # PyTorch's fill of one element
    one_row, one = x[:1].clone(), torch.empty(1, device="cuda")
    launch_floor = {"layer_norm_fwd_one_row_ms": kernel_ms(
        lambda: ln.layer_norm_fwd(one_row, w, bias, 1e-5)),
        "fill_one_element_ms": kernel_ms(lambda: one.fill_(1.0))}

    rows["layer_norm_fwd"] = ln_fwd_row(x)
    rows["layer_norm_fwd@eval"] = ln_fwd_row(
        torch.randn(LN_SHAPES[0][0], 1024, generator=gen).to("cuda", torch.bfloat16))
    for name in ("layer_norm_fwd", "layer_norm_fwd@eval"):
        rows[name]["library_ratio"] = rows[name]["ms"] / rows[name]["library_ms"]
        rows[name]["launch_floor"] = launch_floor

    def plain_bwd():
        xp = x.detach().requires_grad_()
        wp, bp = w.detach().requires_grad_(), bias.detach().requires_grad_()
        ln.layer_norm_reference(xp, wp, bp, 1e-5, torch.bfloat16).backward(dy)

    # the yardstick: PyTorch's LayerNorm backward from the same bf16 rows,
    # all three of dx, dw and db asked for (its own mean and rstd)
    wb, bb = w.bfloat16(), bias.bfloat16()
    _, mu, rstd = torch.ops.aten.native_layer_norm(x, (1024,), wb, bb, 1e-5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows["layer_norm_bwd"] = {
        "ms": kernel_ms(lambda: ln.layer_norm_bwd(x, dy, w, 1e-5)),
        "plain_ms": kernel_ms(plain_bwd),
        "library_ms": kernel_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, (1024,), mu, rstd, wb, bb, [True, True, True])),
        "partial_bytes": ln.bwd_partial_bytes(b * s, 1024, torch.bfloat16, sms),
        "host_us_per_call": host_us(lambda: ln.layer_norm_bwd(x, dy, w, 1e-5)),
        **bound(3 * nbytes + 3 * 1024 * 4, 0)}
    rows["layer_norm_bwd"]["library_ratio"] = (
        rows["layer_norm_bwd"]["ms"] / rows["layer_norm_bwd"]["library_ms"])
    # both directions at bert-base width on the RecipeQA launcher's rows
    rows_, n_ = RQ_ROWS, 768
    xb = torch.randn(rows_, n_, generator=gen).to("cuda", torch.bfloat16)
    dyb = torch.randn(rows_, n_, generator=gen).to("cuda", torch.bfloat16)
    wn, bn_ = torch.ones(n_, device="cuda"), torch.zeros(n_, device="cuda")
    _, mu_b, rstd_b = torch.ops.aten.native_layer_norm(
        xb, (n_,), wn.bfloat16(), bn_.bfloat16(), 1e-5)

    def plain_bwd_b():
        xp = xb.detach().requires_grad_()
        wp, bp = wn.detach().requires_grad_(), bn_.detach().requires_grad_()
        ln.layer_norm_reference(xp, wp, bp, 1e-5, torch.bfloat16).backward(dyb)

    rows["layer_norm_fwd@bert_base"] = {
        "shape": [rows_, n_],
        "ms": kernel_ms(lambda: ln.layer_norm_fwd(xb, wn, bn_, 1e-5)),
        "plain_ms": kernel_ms(lambda: ln.layer_norm_reference(
            xb, wn, bn_, 1e-5, torch.bfloat16)),
        "library_ms": kernel_ms(lambda: torch.nn.functional.layer_norm(
            xb, (n_,), wn.bfloat16(), bn_.bfloat16())),
        **bound(2 * xb.numel() * 2 + 2 * n_ * 4, 0)}
    rows["layer_norm_bwd@bert_base"] = {
        "shape": [rows_, n_],
        "ms": kernel_ms(lambda: ln.layer_norm_bwd(xb, dyb, wn, 1e-5)),
        "plain_ms": kernel_ms(plain_bwd_b),
        "library_ms": kernel_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dyb, xb, (n_,), mu_b, rstd_b, wn.bfloat16(), bn_.bfloat16(),
            [True, True, True])),
        **bound(3 * xb.numel() * 2 + 3 * n_ * 4, 0)}

    # both directions on VisualBERT's train-step rows, in bf16 and in f32
    # (the first layer's attention_ln over the promoted f32 stream)
    for tag, dt in (("vb", torch.bfloat16), ("vb_f32", torch.float32)):
        rows.update(_ln_timing_rows(tag, 8 * VB_S, 1024, dt, gen))
    # both directions on a sequence-parallel rank's rows
    rows.update(_ln_timing_rows("sp", SP_ROWS, 1024, torch.bfloat16, gen))

    # the multimodal path's calls (`make_path_attention_inputs`; their
    # errors are held in kernel_check); an eval micro-batch has no dropout
    for name, shape in MM_SHAPES.items():
        b, h, s, d = shape
        bhsd, bhs = b * h * s * d, b * h * s
        q, k, v, mask = make_path_attention_inputs(name, torch.bfloat16, seed)
        p = DROPOUT_P if name in PATH_DROPOUT else 0.0
        o, lse = att.flash_attention(q, k, v, mask, p, sd)
        rows[f"flash_fwd@{name}"] = {
            "shape_bhsd": list(shape), "dropout_p": p,
            **fwd_row(q, k, v, mask, p, sd, plain_iters=5)}
        if name in EVAL_ONLY:
            continue
        do = torch.randn_like(q)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask.bool()[:, None, None, :], dropout_p=p)
        bwd_ms = kernel_ms(lambda: att.flash_attention_bwd(
            q, k, v, mask, o, lse, do, p, sd))
        lib_ms = kernel_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        rows[f"flash_bwd@{name}"] = {
            "shape_bhsd": list(shape), "dropout_p": p,
            "ms": bwd_ms, "library_ms": lib_ms, "library_ratio": bwd_ms / lib_ms,
            "plain_ms": kernel_ms(lambda: att.attention_bwd_reference(
                q, k, v, mask, o, lse, do, p, sd), iters=5),
            **bound(8 * bhsd * 2 + bhs * 4 + b * s * 4,
                    5 * 2 * b * h * s * s * d)}
    # head width 128 (an HF config of hidden 768 and 6 heads) at the train
    # step's batch and length, with dropout: the kernels' D = 128 instances
    b, h, s, d = D128_SHAPE
    bhsd, bhs = b * h * s * d, b * h * s
    q, k, v, mask = inputs(D128_SHAPE, 260)
    o, lse = att.flash_attention(q, k, v, mask, DROPOUT_P, sd)
    rows["flash_fwd@d128"] = {"shape_bhsd": list(D128_SHAPE),
                              "dropout_p": DROPOUT_P,
                              **fwd_row(q, k, v, mask, DROPOUT_P, sd,
                                        plain_iters=5)}
    do = torch.randn_like(q)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask.bool()[:, None, None, :], dropout_p=DROPOUT_P)
    bwd_ms = kernel_ms(lambda: att.flash_attention_bwd(
        q, k, v, mask, o, lse, do, DROPOUT_P, sd))
    lib_ms = kernel_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    rows["flash_bwd@d128"] = {
        "shape_bhsd": list(D128_SHAPE), "dropout_p": DROPOUT_P,
        "ms": bwd_ms, "library_ms": lib_ms, "library_ratio": bwd_ms / lib_ms,
        "plain_ms": kernel_ms(lambda: att.attention_bwd_reference(
            q, k, v, mask, o, lse, do, DROPOUT_P, sd), iters=5),
        **bound(8 * bhsd * 2 + bhs * 4 + b * s * 4, 5 * 2 * b * h * s * s * d)}
    # the ring attention block: the forward at the block, and the
    # backward's main kernel under the ring's global lse (the pre-pass once
    # per position, the post-pass once, are the train rows' kernels)
    q, k, v, mask = make_ring_inputs(torch.bfloat16, seed)
    b, h, s, d = q.shape
    n = s // RING_SIZE
    qi, kr, vr = (ring_block(x, j, n).contiguous()
                  for x, j in ((q, 1), (k, 2), (v, 2)))
    mr = mask[:, 2 * n:3 * n].contiguous()
    rows["flash_fwd@ring_block"] = {
        "shape_bhsd": list(qi.shape), "dropout_p": 0.0,
        **fwd_row(qi, kr, vr, mr, 0.0, sd, plain_iters=5)}
    o, lse = att.attention_reference_lse(q, k, v, mask)
    oi = ring_block(o, 1, n).contiguous()
    lse_i = lse.view(b, h, s)[:, :, n:2 * n].reshape(b * h, n).contiguous()
    del o, lse
    do = torch.randn_like(qi)
    delta, lse2, acc, turns = att.flash_bwd_prep(oi, do, lse_i)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qi, kr, vr))
    out = F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mr.bool()[:, None, None, :])
    main_ms = kernel_ms(lambda: att.flash_bwd_main(
        qi, kr, vr, mr, lse2, delta, acc, turns, do))
    lib_ms = kernel_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    bhsd, bhs = b * h * n * d, b * h * n
    rows["flash_bwd@ring_block"] = {
        "shape_bhsd": list(qi.shape), "dropout_p": 0.0,
        "kernel_timed": "flash_bwd_main under the global lse",
        "ms": main_ms, "library_ms": lib_ms, "library_ratio": main_ms / lib_ms,
        "plain_ms": kernel_ms(lambda: att.attention_bwd_reference(
            qi, kr, vr, mr, oi, lse_i, do), iters=5),
        # reads q, k, v, dO, lse, delta and the mask; writes dq, dk and dv
        **bound(7 * bhsd * 2 + 2 * bhs * 4 + b * n * 4,
                5 * 2 * b * h * n * n * d)}
    for name, row in rows.items():
        emit({"phase": "timing", "kernel": name, **row})
    # every backward row against SDPA's backward on the same inputs, and
    # the rows where the kernels are still the slower
    ratios = {name: row["library_ratio"] for name, row in rows.items()
              if name == "flash_bwd" or name.startswith("flash_bwd@")}
    emit({"phase": "timing", "summary": "flash_bwd / SDPA backward",
          "library_ratio": ratios,
          "above_1": sorted(n for n, r in ratios.items() if r > 1.0),
          "train_shape_ms": {"whole": rows["flash_bwd"]["ms"],
                             "main": rows["flash_bwd"]["main_ms"]}})
    return rows


def _ln_timing_rows(tag, rows_, n, dtype, gen) -> dict:
    """The LayerNorm kernels' forward and backward rows at (rows_, n) in
    `dtype`: kernel, plain (autograd of the plain version for the
    backward) and PyTorch's LayerNorm on the same inputs, and the bound
    (each of x, dy, w, b read once, y or dx, dw, db written once)."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    x = torch.randn(rows_, n, generator=gen).to("cuda", dtype)
    dy = torch.randn(rows_, n, generator=gen).to("cuda", dtype)
    w, b = torch.ones(n, device="cuda"), torch.zeros(n, device="cuda")
    wl, bl = w.to(dtype), b.to(dtype)
    _, mu, rstd = torch.ops.aten.native_layer_norm(x, (n,), wl, bl, 1e-5)
    size = x.element_size()

    def plain_bwd():
        xp = x.detach().requires_grad_()
        wp, bp = w.detach().requires_grad_(), b.detach().requires_grad_()
        ln.layer_norm_reference(xp, wp, bp, 1e-5, dtype).backward(dy)

    return {f"layer_norm_fwd@{tag}": {
        "shape": [rows_, n], "dtype": str(dtype).split(".")[-1],
        "ms": kernel_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-5)),
        "plain_ms": kernel_ms(lambda: ln.layer_norm_reference(
            x, w, b, 1e-5, dtype)),
        "library_ms": kernel_ms(lambda: torch.nn.functional.layer_norm(
            x, (n,), wl, bl)),
        **bound(2 * x.numel() * size + 2 * n * 4, 0)},
        f"layer_norm_bwd@{tag}": {
        "shape": [rows_, n], "dtype": str(dtype).split(".")[-1],
        "ms": kernel_ms(lambda: ln.layer_norm_bwd(x, dy, w, 1e-5)),
        "plain_ms": kernel_ms(plain_bwd),
        "library_ms": kernel_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, (n,), mu, rstd, wl, bl, [True, True, True])),
        **bound(3 * x.numel() * size + 3 * n * 4, 0)}}


def write_png(path: str, rgb) -> None:
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array, written with the
    standard library alone (no imaging package needed)."""
    import struct
    import zlib
    h, w, _ = rgb.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_wikihow(root: str, split: str, n_stories: int, seed: int,
                  images: bool = False, steps_of=None, words=None) -> dict:
    """A WikiHow-schema split of 5-step stories whose steps fill
    `per_seq_max_length` = 60 tokens, so a packed story is ~300 tokens;
    `steps_of(a)`: story a's step count instead, `words`: a (low, high)
    range of words a step instead of 70. With `images`, each step has a
    256 x 192 PNG (blocks of random colour, so the loader's resize to 224
    runs) under the mirror layout the processor resolves, and the images
    are returned by path."""
    import numpy as np
    rng = np.random.default_rng(seed)
    written = {}
    img_dir = os.path.join(root, "www.wikihow.com", "images")
    if images:
        os.makedirs(img_dir, exist_ok=True)
    with open(os.path.join(root, f"wikihow-{split}.json"), "w") as f:
        for a in range(n_stories):
            steps = []
            for s in range(5 if steps_of is None else steps_of(a)):
                size = 70 if words is None else int(rng.integers(*words))
                words_ = rng.choice(WORDS, size=size).tolist()
                assets = {}
                if images:
                    name = f"{split}_{a}_{s}.png"
                    blocks = rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)
                    path = os.path.join(img_dir, name)
                    written[path] = np.kron(blocks,
                                            np.ones((32, 32, 1), np.uint8))
                    write_png(path, written[path])
                    assets = {"image-large": f"images/{name}"}
                steps.append({
                    "step_headline": f"Step {s}",
                    "step_text": {"text": f"Story {a} step {s}. "
                                  + " ".join(words_),
                                  "bullet_points": []},
                    "step_assets": assets})
            f.write(json.dumps({
                "url": f"https://wikihow.test/{split}/{a}", "title": f"Story {a}",
                "summary": "", "sections": [{"steps": steps}]}) + "\n")
    return written


def _eval_argv(data_dir, out_dir, seed, *extra, model="simple"):
    return ["--model_name_or_path", model, "--model_size", "large",
            "--replace_token_type_embeddings", "--task_name", "wikihow_sort",
            "--hierarchical_version", "v1", "--sort_method", "heat_map",
            "--data_dir", data_dir, "--eval_splits", "test",
            "--max_seq_length", "320", "--per_seq_max_length", "60",
            "--per_gpu_eval_batch_size", "8", "--seed", str(seed),
            "--output_dir", out_dir, "--device", "cuda", *extra]


def _wrappers():
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.ops import gelu as gl
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    return {"flash_fwd": att.flash_attention,
            "flash_bwd_prep": att.flash_bwd_prep,
            "flash_bwd_main": att.flash_bwd_main,
            "flash_bwd_post": att.flash_bwd_post,
            "flash_bwd_dq_f32": att.flash_attention_bwd_dq,
            "flash_bwd_dkv_f32": att.flash_attention_bwd_dkv,
            "keep_bits_dump": att.dump_keep_bits,
            "gelu_logit_erf_fwd": gl.gelu_logit_erf_fwd,
            "gelu_logit_erf_bwd": gl.gelu_logit_erf_bwd,
            "layer_norm_fwd": ln.layer_norm_fwd,
            "layer_norm_bwd": ln.layer_norm_bwd}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _median_after_first(xs):  # the first batch or step also warms the card up
    rest = sorted(xs[1:]) or xs
    return rest[len(rest) // 2]


def _check_eval_outputs(out_dir, n_stories):
    with open(os.path.join(out_dir, "output_order.txt")) as f:
        orders = [[int(x) for x in line.split()] for line in f]
    return (len(orders) == n_stories
            and all(sorted(o) == list(range(5)) for o in orders))


def phase_main_path(seed: int, work: str):
    """The port's eval CLI at full RoBERTa-large width on the card."""
    from multimodal_sequencing_tpu_torch.train.cli import run_eval
    from multimodal_sequencing_tpu_torch.train.evaluation import paper_result_line
    data_dir = os.path.join(work, "data")
    out_dir = os.path.join(work, "eval_out")
    os.makedirs(data_dir, exist_ok=True)
    write_wikihow(data_dir, "test", N_STORIES, seed)
    _reset_counts()
    t0 = time.perf_counter()
    results, evaluator = run_eval(_eval_argv(data_dir, out_dir, seed))
    wall_s = time.perf_counter() - t0
    counts = _read_counts()
    batches = math.ceil(N_STORIES / 8)
    perms = _check_eval_outputs(out_dir, N_STORIES)
    headers, row = paper_result_line(results["test"])
    fwd, dec = evaluator.forward_seconds, evaluator.decode_seconds
    summary = {
        "phase": "main_path", "stories": N_STORIES, "batches": len(fwd),
        "forwards": evaluator.forwards, "launches": counts,
        "launches_per_forward": counts["flash_fwd"] / max(evaluator.forwards, 1),
        "all_permutations": perms,
        "first_batch_s": fwd[0] + dec[0],
        "median_batch_s": _median_after_first([f + d for f, d in zip(fwd, dec)]),
        "median_forward_s": _median_after_first(fwd),
        "median_decode_s": _median_after_first(dec),
        "wall_s_incl_init": wall_s, "metrics": results["test"],
        "paper_row": [headers, row]}
    emit(summary)
    print(headers, flush=True)
    print(row, flush=True)
    if not (evaluator.forwards == batches and perms
            and all(counts[k] == batches * PER_FORWARD[k]
                    for k in PATH_KERNELS["eval"])):
        raise AssertionError(f"main path check failed: {summary}")
    return counts


def phase_train_path(seed: int, work: str):
    """The port's train CLI at full RoBERTa-large width on the card, then the
    eval CLI on its checkpoint."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import main_train, run_eval
    data_dir = os.path.join(work, "train_data")
    out_dir = os.path.join(work, "train_out")
    os.makedirs(data_dir, exist_ok=True)
    write_wikihow(data_dir, "train", 8 * TRAIN_STEPS, seed)
    write_wikihow(data_dir, "test", 16, seed + 1)
    argv = ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_train_batch_size", "8",
            "--learning_rate", "1e-5", "--warmup_steps", "2",
            "--max_steps", str(TRAIN_STEPS), "--logging_steps", "1",
            "--save_steps", "0", "--gelu_impl", "logit_erf",
            "--attention_dropout_mode", "probs", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = main_train(argv)
    wall_s = time.perf_counter() - t0
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in res.history]
    times = [h["time"] for h in res.history]
    step_s = [b - a for a, b in zip([res.start_time] + times[:-1], times)]
    med = _median_after_first(step_s)
    ckpt = os.path.join(out_dir, f"checkpoint-{res.global_step}")
    summary = {
        "phase": "train_path", "steps": res.global_step, "launches": counts,
        "losses": losses, "grad_norms": [h["grad_norm"] for h in res.history],
        "step_s": step_s, "median_step_s_after_first": med,
        "stories_per_s": 8 / med, "peak_memory_gib": peak_gb,
        "wall_s_incl_init": wall_s, "checkpoint": os.path.basename(ckpt)}
    emit(summary)
    ok = (res.global_step == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses)
          and len(set(losses)) > 1
          and all(counts[k] == TRAIN_STEPS * PER_FORWARD[k]
                  for k in PATH_KERNELS["train"])
          and all(counts[k] == 0 for k in F32_BWD)
          and os.path.isfile(os.path.join(ckpt, "model.pt"))
          and os.path.isfile(os.path.join(ckpt, "simple_tokenizer.json")))
    if not ok:
        raise AssertionError(f"train path check failed: {summary}")
    # the checkpoint as --model_name_or_path: its tokenizer and its weights
    ev_dir = os.path.join(work, "train_eval")
    results, evaluator = run_eval(_eval_argv(data_dir, ev_dir, seed, model=ckpt))
    perms = _check_eval_outputs(ev_dir, 16)
    emit({"phase": "train_path", "eval_of_checkpoint": results["test"],
          "forwards": evaluator.forwards, "all_permutations": perms})
    if not perms:
        raise AssertionError("eval of the trained checkpoint failed")
    return counts


KERNEL_CLASSES = (("flash_fwd", ("flash_fwd",)),
                  ("flash_bwd", ("flash_bwd_",)),
                  ("gelu_logit_erf", ("gelu_kernel",)),
                  ("layer_norm", ("layer_norm_fwd", "layer_norm_bwd")),
                  ("matmul", ("gemm", "sm90_", "cutlass", "xmma", "cublas",
                              "nvjet")),
                  ("optimizer (foreach)", ("foreach", "multi_tensor")),
                  ("reduce", ("reduce",)),
                  ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _gelu_kind(key: str):
    """"fwd" or "bwd" for a GELU kernel's (demangled) name, else None."""
    if "gelu_kernel" not in key:
        return None
    return "bwd" if "true>" in key else "fwd"


# cuDNN's convolution kernels, a class of their own on the multimodal paths
CONV_CLASS = ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                       "implicit", "winograd"))


def _by_class(prof, wall_ms, classes=KERNEL_CLASSES):
    import torch
    by_class = {name: 0.0 for name, _ in classes}
    by_class["other"] = 0.0
    kernels = []
    for evt in prof.key_averages():
        # kernel events only: a CPU op's device time repeats its kernels'
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        key = evt.key.lower()
        cls = next((name for name, pats in classes
                    if any(p in key for p in pats)), "other")
        by_class[cls] += ms
        kernels.append((ms, evt.count, evt.key[:80]))
    busy = sum(by_class.values())
    return {"device_ms_by_class": by_class, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            # redesigned kernels, apart from their class
            "flash_fwd_device_ms": sum(ms for ms, _, key in kernels
                                       if "flash_fwd" in key),
            "layer_norm_fwd_device_ms": sum(ms for ms, _, key in kernels
                                            if "layer_norm_fwd" in key),
            "layer_norm_bwd_device_ms": sum(ms for ms, _, key in kernels
                                            if "layer_norm_bwd" in key),
            "gelu_fwd_device_ms": sum(ms for ms, _, key in kernels
                                      if _gelu_kind(key) == "fwd"),
            "gelu_bwd_device_ms": sum(ms for ms, _, key in kernels
                                      if _gelu_kind(key) == "bwd"),
            "top_kernels": sorted(kernels, reverse=True)[:10]}


def _full_width_model(seed, **enc):
    from multimodal_sequencing_tpu_torch.models.config import (
        EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    cfg = MultimodalConfig(encoder=EncoderConfig.roberta_large(type_vocab_size=5, **enc),
                           hierarchical_version="v1", max_seq_length=320)
    return cfg, init_weights(SequencingModel(cfg), seed)


def _random_batch(cfg, b, s, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.encoder.vocab_size, (b, s)).astype(np.int32)
    ids[:, ::64] = cfg.cls_id
    types = np.broadcast_to(np.arange(s) // 64, (b, s)).astype(np.int32)
    labels = np.stack([rng.permutation(5) for _ in range(b)]).astype(np.int32)
    return {"input_ids": ids, "attention_mask": np.ones((b, s), np.int32),
            "token_type_ids": types, "labels": labels,
            "valid": np.ones(b, bool)}


def phase_breakdown(seed: int):
    """Device time of one warm eval forward (B = 32, S = 320, 24 layers,
    bf16) by kernel class, from torch.profiler, beside its wall time; and
    what the Flax-form LayerNorm costs it: its kernel and its plain version
    against PyTorch's own layer_norm in bf16 on the same rows."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from multimodal_sequencing_tpu_torch.models.sequencer import cast_for_inference
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    b, _, s, _ = EVAL_SHAPE
    cfg, model = _full_width_model(seed)
    model = cast_for_inference(model.to("cuda")).eval()
    batch = _random_batch(cfg, b, s, seed)
    ids, mask, types = (torch.from_numpy(batch[k]).long().cuda() for k in
                        ("input_ids", "attention_mask", "token_type_ids"))
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: model(ids, mask, types), iters=10)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(ids, mask, types)
            torch.cuda.synchronize()
        x = torch.randn(b, s, 1024, device="cuda").bfloat16()
        w, bias = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
        ln_ms = kernel_ms(lambda: ln.layer_norm(x, w, bias, 1e-5, torch.bfloat16))
        plain_ms = kernel_ms(lambda: ln.layer_norm_reference(
            x, w, bias, 1e-5, torch.bfloat16))
        torch_ms = kernel_ms(lambda: F.layer_norm(x, (1024,), w.bfloat16(),
                                              bias.bfloat16(), 1e-5))
    n_ln = PER_FORWARD["layer_norm_fwd"]
    emit({"phase": "breakdown", "path": "eval forward", "shape_bs": [b, s],
          "forward_ms": forward_ms, **_by_class(prof, forward_ms),
          "layer_norm_calls_per_forward": n_ln,
          "layer_norm_ms_per_call": {"kernel": ln_ms, "plain": plain_ms,
                                     "torch_bf16": torch_ms},
          "layer_norm_cost_vs_torch_ms_per_forward": {
              "kernel": n_ln * (ln_ms - torch_ms),
              "plain": n_ln * (plain_ms - torch_ms)}})


def phase_train_breakdown(seed: int):
    """Device time of one warm train step at the train shape (B = 8,
    S = 320, 24 layers, bf16 compute, dropout 0.1) by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import train_step
    b, _, s, _ = TRAIN_SHAPE
    cfg, model = _full_width_model(seed)
    model = model.to("cuda").train()
    opt = AdamW(model, learning_rate=1e-5, warmup_steps=2, total_steps=100)
    batch = _random_batch(cfg, b, s, seed)
    step = [0]

    def one():
        out = train_step(model, opt, batch, step[0], seed)
        step[0] += 1
        return out

    step_ms = cuda_ms(one, iters=5, warmup=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)
    by_class = _by_class(prof, step_ms)
    emit({"phase": "train_breakdown", "shape_bs": [b, s], "step_ms": step_ms,
          "attention_bwd_device_ms": by_class["device_ms_by_class"]["flash_bwd"],
          **by_class,
          "host_ms_profiled_step": sum(h[0] for h in host),
          "top_host_ops": host[:12]})


def phase_reference(seed: int):
    """The sequencer at full width, 2 layers, f32: card (kernel) against the
    CPU (plain version) on the same packed stories and weights."""
    import copy
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import SimpleWordTokenizer
    tok = SimpleWordTokenizer()
    cfg, model = _full_width_model(seed, vocab_size=len(tok),
                                   num_hidden_layers=2, dtype="float32")
    packer = StoryPacker(tok, 320, 60)
    rng = np.random.default_rng(seed)
    stories = [[" ".join(rng.choice(WORDS, size=int(rng.integers(10, 70))))
                for _ in range(int(rng.integers(3, 6)))] for _ in range(4)]
    packs = [packer.pack_story(t) for t in stories]
    ids, am, tt = (torch.from_numpy(np.stack([p[i] for p in packs])).long()
                   for i in range(3))
    model = model.eval()
    with torch.inference_mode():
        want = model(ids, am, tt)
    card = copy.deepcopy(model).cuda()
    with torch.inference_mode():
        got = card(ids.cuda(), am.cuda(), tt.cuda())
    err = {key: (got[key].float().cpu() - want[key].float()).abs().max().item()
           for key in ("heatmap", "step_reprs")}
    tol = 2e-4
    ok = (all(e <= tol for e in err.values())
          and torch.equal(got["present"].cpu(), want["present"]))
    emit({"phase": "reference", "layers": 2, "dtype": "float32",
          "max_abs_err": err, "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the 2-layer sequencer")


def phase_train_reference(seed: int):
    """Four train steps of the 2-layer full-width sequencer in f32 at dropout
    0: card (kernels) against the CPU (plain versions) on the same weights
    and batches: losses, grad norms, the first step's gradients and the
    weights after three updates of nonzero learning rate."""
    import copy
    import torch
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import train_step
    lr, n_steps = 1e-3, 4
    cfg, cpu_model = _full_width_model(
        seed, num_hidden_layers=2, dtype="float32", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    init = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    card_model = copy.deepcopy(cpu_model).cuda()
    batches = [_random_batch(cfg, 4, 320, seed + i) for i in range(n_steps)]
    hist, grads = {}, {}
    for name, model in (("cpu", cpu_model), ("cuda", card_model)):
        # warmup 1: the schedule gives the first step learning rate 0 and
        # the other three lr * (1 - (count - 1) / 9)
        opt = AdamW(model, learning_rate=lr, warmup_steps=1, total_steps=10,
                    weight_decay=0.01)
        hist[name] = []
        for i, bt in enumerate(batches):
            hist[name].append({k: float(v) for k, v in
                               train_step(model.train(), opt, bt, i, seed).items()})
            if i == 0:
                grads[name] = {n: p.grad.detach().double().cpu() for n, p in
                               model.named_parameters() if p.grad is not None}
    total = math.sqrt(sum(g.norm().item() ** 2 for g in grads["cpu"].values()))
    grad_rel = sorted(((grads["cuda"][n] - g).norm().item() / total, n)
                      for n, g in grads["cpu"].items())[::-1]
    card_params = dict(card_model.named_parameters())
    w_err = {"key_bias": 0.0, "other": 0.0}
    moved = 0.0
    for n, p in cpu_model.named_parameters():
        kind = "key_bias" if n.endswith("key.bias") else "other"
        w_err[kind] = max(w_err[kind], (card_params[n].detach().cpu()
                                        - p.detach()).abs().max().item())
        if kind == "other":
            moved = max(moved, (p.detach() - init[n]).abs().max().item())
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)  # noqa: E731
    loss_err = max(rel(g["loss"], w["loss"]) for g, w in zip(hist["cuda"], hist["cpu"]))
    gn_err = max(rel(g["grad_norm"], w["grad_norm"])
                 for g, w in zip(hist["cuda"], hist["cpu"]))
    # loss, grad norm and each parameter's gradient (its error over the
    # global norm): f32 sums in another order, relative 1e-5. Weights: an
    # Adam update moves a weight by up to ~lr, so a wrong update shows at
    # lr / 25 (the weights must have moved by 10 times that). The attention
    # key biases get a gradient that is zero but for rounding (softmax is
    # invariant to a shift of a row's scores), which Adam may turn into a
    # step of up to lr either way on each side in each update.
    tol = {"loss_rel": 1e-5, "grad_norm_rel": 1e-5, "grad_rel_to_norm": 1e-5,
           "weight_abs": lr / 25, "key_bias_abs": 2 * lr * (n_steps - 1),
           "min_weight_move": 10 * lr / 25}
    ok = (loss_err <= tol["loss_rel"] and gn_err <= tol["grad_norm_rel"]
          and grad_rel[0][0] <= tol["grad_rel_to_norm"]
          and w_err["other"] <= tol["weight_abs"]
          and w_err["key_bias"] <= tol["key_bias_abs"]
          and moved >= tol["min_weight_move"])
    emit({"phase": "train_reference", "layers": 2, "dtype": "float32",
          "steps": n_steps, "history": hist, "loss_rel_err": loss_err,
          "grad_norm_rel_err": gn_err, "max_abs_weight_err": w_err,
          "max_abs_weight_move": moved, "worst_grad_rel_err": grad_rel[:5],
          "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the 2-layer train steps")


def write_hf_roberta(path: str, seed: int) -> dict:
    """A local HF RoBERTa-large directory: `config.json` at the published
    widths and a `pytorch_model.bin` of f32 weights drawn from `seed` under
    HF key names, the embeddings and the even layers under `roberta.` (as
    an HF task model keeps them). Returns the state dict written."""
    import torch
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(HF_ROBERTA_LARGE, f, indent=2)
    c = HF_ROBERTA_LARGE
    h, ff = c["hidden_size"], c["intermediate_size"]
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std=0.02, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    sd = {}

    def dense(key, n_out, n_in, prefixed):
        pre = "roberta." if prefixed else ""
        sd[f"{pre}{key}.weight"] = normal(n_out, n_in)
        sd[f"{pre}{key}.bias"] = normal(n_out)

    def ln(key, prefixed):
        pre = "roberta." if prefixed else ""
        sd[f"{pre}{key}.weight"] = normal(h, mean=1.0)
        sd[f"{pre}{key}.bias"] = normal(h)

    for name, rows in (("word", c["vocab_size"]),
                       ("position", c["max_position_embeddings"]),
                       ("token_type", c["type_vocab_size"])):
        sd[f"roberta.embeddings.{name}_embeddings.weight"] = normal(rows, h)
    ln("embeddings.LayerNorm", True)
    for i in range(c["num_hidden_layers"]):
        p, pre = f"encoder.layer.{i}", i % 2 == 0
        for proj in ("query", "key", "value"):
            dense(f"{p}.attention.self.{proj}", h, h, pre)
        dense(f"{p}.attention.output.dense", h, h, pre)
        ln(f"{p}.attention.output.LayerNorm", pre)
        dense(f"{p}.intermediate.dense", ff, h, pre)
        dense(f"{p}.output.dense", h, ff, pre)
        ln(f"{p}.output.LayerNorm", pre)
    dense("pooler.dense", h, h, False)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return sd


def _hf_key(port_key: str) -> str:
    """The HF name (prefix stripped) of a port encoder parameter, written
    out here apart from `models/convert.py`, which it checks."""
    key = port_key.replace("embeddings.ln.", "embeddings.LayerNorm.")
    if key.startswith("layer_"):
        i, rest = key[len("layer_"):].split(".", 1)
        rest = {"attention.query": "attention.self.query",
                "attention.key": "attention.self.key",
                "attention.value": "attention.self.value",
                "attention.out": "attention.output.dense",
                "attention_ln": "attention.output.LayerNorm",
                "intermediate": "intermediate.dense",
                "output": "output.dense",
                "output_ln": "output.LayerNorm"}[rest.rsplit(".", 1)[0]] + \
            "." + rest.rsplit(".", 1)[1]
        key = f"encoder.layer.{i}.{rest}"
    elif key.startswith("pooler."):
        key = "pooler.dense." + key[len("pooler."):]
    return key


def _check_hf_weights(model, sd) -> dict:
    """The encoder's weights against the HF file's, before the first step:
    every one equal, the token-type table the file's one row tiled to 5."""
    import torch
    flat = {k[len("roberta."):] if k.startswith("roberta.") else k: v
            for k, v in sd.items()}
    tt = "embeddings.token_type_embeddings.weight"
    mismatched, checked = [], 0
    for key, param in model.encoder.state_dict().items():
        want = flat[_hf_key(key)]
        if key == tt:
            want = want.repeat(5, 1)
        checked += 1
        if not torch.equal(param.detach().cpu(), want):
            mismatched.append(key)
    return {"checked": checked, "mismatched": mismatched[:5],
            "token_type_rows": int(model.encoder.state_dict()[tt].shape[0])}


def _decode_score(hm, order, method) -> float:
    """The exhaustive decode's objective of one order, in f64: the chain
    (or |chain| for v3) of log(x + 1e-8) or of x for `_sum`, plus the
    closing term for v2 (1 - hm[last, first]) and v3 (|hm[last, first]|)."""
    import numpy as np
    hm = np.abs(hm.astype(np.float64)) if "v3" in method else hm.astype(
        np.float64)
    f = (lambda x: x) if "sum" in method else (lambda x: np.log(x + 1e-8))
    total = sum(f(hm[a, b]) for a, b in zip(order[:-1], order[1:]))
    if "v2" in method:
        total += f(1.0 - hm[order[-1], order[0]])
    elif "v3" in method:
        total += f(hm[order[-1], order[0]])
    return float(total)


def _decode_on_card_vs_cpu(heatmaps: dict) -> dict:
    """Each device decoder on the card against the same decoder on the CPU,
    for every heat map set: equal orders, or orders that tie."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.ops import order_decode as od
    out = {}
    for method in DEVICE_DECODE_METHODS:
        stats = {"orders": 0, "differ": 0, "worst_tie_rel": 0.0, "bad": []}
        for name, hm in heatmaps.items():
            n = hm.shape[-1]
            t = torch.from_numpy(hm)
            if method == "topological":
                got = od.topological_decode_batch(t.cuda(), n).cpu().numpy()
                want = od.topological_decode_batch(t, n).numpy()
            else:
                got = od.exhaustive_naive_decode(t.cuda(), n, method)
                got = got.cpu().numpy()
                want = od.exhaustive_naive_decode(t, n, method).numpy()
            stats["orders"] += len(want)
            for k in np.nonzero((got != want).any(-1))[0]:
                stats["differ"] += 1
                if method == "topological":  # no score: orders must agree
                    stats["bad"].append([name, int(k)])
                    continue
                a = _decode_score(hm[k], got[k].tolist(), method)
                b = _decode_score(hm[k], want[k].tolist(), method)
                rel = abs(a - b) / max(1.0, abs(b))
                stats["worst_tie_rel"] = max(stats["worst_tie_rel"], rel)
                if rel > DECODE_TIE_REL:
                    stats["bad"].append([name, int(k), a, b])
        out[method] = stats
    # torch.argmax gives the first of equal maxima on the card
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(256, 5040)
    i = torch.randint(0, 5040, (256,), generator=gen)
    j = torch.randint(0, 5040, (256,), generator=gen)
    x[torch.arange(256), i] = 1.0
    x[torch.arange(256), j] = 1.0
    out["argmax_first_on_card"] = bool(torch.equal(
        x.cuda().argmax(-1).cpu(), torch.minimum(i, j)))
    return out


def _packer_timing(stories, tokenizer, reps: int = 20) -> dict:
    """Host time to pack `stories` at S = 320: the native packer against
    numpy, on the same step ids; the packs must be identical."""
    import numpy as np
    from multimodal_sequencing_tpu_torch.data import _native
    from multimodal_sequencing_tpu_torch.data.packing import (StoryPacker,
                                                              pack_numpy)
    packer = StoryPacker(tokenizer, 320, 60)
    steps = [packer.encode_steps(t) for t in stories]
    pad = tokenizer.pad_token_id
    same = all(np.array_equal(a, b) for st in steps for a, b in zip(
        _native.pack_story(st, 320, pad), pack_numpy(st, 320, pad)))
    us = {}
    for name, fn in (("numpy", pack_numpy), ("native", _native.pack_story),
                     ("native_2", _native.pack_story),
                     ("numpy_2", pack_numpy)):
        t0 = time.perf_counter()
        for _ in range(reps):
            for st in steps:
                fn(st, 320, pad)
        us[name] = (time.perf_counter() - t0) / (reps * len(steps)) * 1e6
    return {"identical_packs": same, "stories": len(steps),
            "us_per_story": us}


def phase_hf_path(seed: int, work: str):
    """Fine-tune from a local HF RoBERTa-large directory through the train
    CLI (4 steps, a checkpoint every 2), sweep both checkpoints through the
    eval CLI with `--device_decode --eval_all_checkpoints`, hold the card's
    order decode against the CPU's, and time device against host decode and
    the native packer against numpy."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data import _native
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.train import loop
    from multimodal_sequencing_tpu_torch.train.cli import (
        _evaluator, build_config, load_model_for_eval, main_train, parse_args,
        run_eval)
    if not _native.available():
        raise AssertionError(
            f"the native packer did not build: {_native.build_error()}")
    emit({"phase": "hf_path", "packer": "native",
          "library": str(_native.library_path())})
    hf_dir = os.path.join(work, "hf_roberta_large")
    data_dir = os.path.join(work, "hf_data")
    out_dir = os.path.join(work, "hf_out")
    os.makedirs(data_dir)
    write_wikihow(data_dir, "train", 8 * HF_STEPS, seed + 2)
    write_wikihow(data_dir, "test", N_STORIES, seed + 3)
    t0 = time.perf_counter()
    sd = write_hf_roberta(hf_dir, seed)
    write_s = time.perf_counter() - t0
    argv = ["--model_name_or_path", hf_dir, "--tokenizer_name", "simple",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_train_batch_size", "8",
            "--learning_rate", "1e-5", "--warmup_steps", "1",
            "--max_steps", str(HF_STEPS), "--logging_steps", "1",
            "--save_steps", "2", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda"]
    # hold the weights the run starts from against the file, before its
    # first step
    checks = {}
    real_step = loop.train_step

    def checked_step(model, *a, **kw):
        if not checks:
            checks.update(_check_hf_weights(model, sd))
        return real_step(model, *a, **kw)

    loop.train_step = checked_step
    _reset_counts()
    t0 = time.perf_counter()
    try:
        res = main_train(argv)
    finally:
        loop.train_step = real_step
    wall_s = time.perf_counter() - t0
    counts = _read_counts()
    del sd
    losses = [h["loss"] for h in res.history]
    times = [h["time"] for h in res.history]
    step_s = [b - a for a, b in zip([res.start_time] + times[:-1], times)]
    ckpts = sorted(d for d in os.listdir(out_dir)
                   if d.startswith("checkpoint-"))
    # step k's interval holds the checkpoint written after step k - 1
    # when k - 1 is a multiple of 2
    no_save = [t for k, t in enumerate(step_s, 1) if k > 1 and (k - 1) % 2]
    summary = {"phase": "hf_path", "part": "train", "hf_write_s": write_s,
               "weights_check": checks, "steps": res.global_step,
               "losses": losses, "step_s": step_s,
               "step_s_without_checkpoint_write": no_save,
               "checkpoints": ckpts, "launches": counts,
               "wall_s_incl_init": wall_s}
    emit(summary)
    if not (checks.get("checked") == 16 * NUM_LAYERS + 7
            and not checks["mismatched"] and checks["token_type_rows"] == 5
            and res.global_step == HF_STEPS
            and all(math.isfinite(x) for x in losses)
            and ckpts == ["checkpoint-2", "checkpoint-4"]
            and all(counts[k] == HF_STEPS * PER_FORWARD[k]
                    for k in PATH_KERNELS["train"])):
        raise AssertionError(f"HF train check failed: {summary}")

    # the sweep: both checkpoints, device decode on the card
    sweep_dir = os.path.join(work, "hf_sweep")
    _reset_counts()
    results, evaluator = run_eval(_eval_argv(
        data_dir, sweep_dir, seed, "--model_name_or_path_1", out_dir,
        "--eval_all_checkpoints", "--device_decode"))
    eval_counts = _read_counts()
    files = sorted(f for f in os.listdir(sweep_dir)
                   if f.startswith("eval_results_split_"))
    batches = 2 * math.ceil(N_STORIES / 8)
    summary = {"phase": "hf_path", "part": "sweep", "results": results,
               "files": files, "forwards": evaluator.forwards,
               "launches": eval_counts,
               "all_permutations": _check_eval_outputs(sweep_dir, N_STORIES)}
    emit(summary)
    if not (sorted(results) == ckpts
            and all(sorted(r) == ["test"] for r in results.values())
            and files == [f"eval_results_split_test_{c}.txt" for c in ckpts]
            and summary["all_permutations"]
            and evaluator.forwards == batches
            and all(eval_counts[k] == batches * PER_FORWARD[k]
                    for k in PATH_KERNELS["eval"])):
        raise AssertionError(f"HF sweep check failed: {summary}")

    # device decode against host decode on the last checkpoint: the eval
    # batch time and its split, in turns
    ckpt = os.path.join(out_dir, ckpts[-1])
    split = {}
    for name, extra in (("host", []), ("device", ["--device_decode"]),
                        ("device_2", ["--device_decode"]), ("host_2", [])):
        _, ev = run_eval(_eval_argv(data_dir, os.path.join(work, f"hf_{name}"),
                                    seed, "--model_name_or_path_1", ckpt,
                                    *extra))
        fwd, dec = ev.forward_seconds, ev.decode_seconds
        split[name] = {
            "median_batch_s": _median_after_first(
                [f + d for f, d in zip(fwd, dec)]),
            "median_forward_s": _median_after_first(fwd),
            "median_decode_s": _median_after_first(dec)}
    emit({"phase": "hf_path", "part": "decode_timing", "batch": 8,
          "stories": N_STORIES, "split": split})

    # the card's decode against the CPU's: the checkpoint's heat maps of 40
    # stories, random maps at n = 5 and n = 7, and maps of clean orders
    args = parse_args("eval", _eval_argv(data_dir, work, seed))
    cfg, tok = build_config(args)
    model = load_model_for_eval(cfg, ckpt, torch.device("cuda"))
    rng = np.random.default_rng(seed)
    stories = [[" ".join(rng.choice(WORDS, size=60)) for _ in range(5)]
               for _ in range(N_STORIES)]
    heatmaps = {
        "checkpoint": _evaluator(args, cfg, tok, torch.device("cuda"))
        .story_logits(model, stories, want="heatmap").astype(np.float32),
        "random_5": rng.uniform(0, 1, (512, 5, 5)).astype(np.float32),
        "random_7": rng.uniform(0, 1, (64, 7, 7)).astype(np.float32)}
    clean = np.zeros((64, 5, 5), np.float32)
    for hm in clean:
        pos = np.argsort(rng.permutation(5))
        hm[:] = np.where(pos[None, :] == pos[:, None] + 1, 1.0,
                         np.where(pos[None, :] > pos[:, None], 0.1, 0.0))
    heatmaps["clean_5"] = clean
    decode = _decode_on_card_vs_cpu(heatmaps)
    emit({"phase": "hf_path", "part": "decode_check",
          "heatmaps": {k: list(v.shape) for k, v in heatmaps.items()},
          "tie_rel_tol": DECODE_TIE_REL, **decode})
    bad = {m: st["bad"][:3] for m, st in decode.items()
           if isinstance(st, dict) and st["bad"]}
    if bad or not decode["argmax_first_on_card"]:
        raise AssertionError(f"card and CPU decode disagree: {bad}")

    # the native packer against numpy on these stories
    pack = _packer_timing(stories, SimpleWordTokenizer())
    emit({"phase": "hf_path", "part": "packer", **pack})
    if not pack["identical_packs"]:
        raise AssertionError("native and numpy packs differ")
    return {"hf_train": counts, "hf_eval": eval_counts}


def _loss_and_grads(model, batch, step, seed):
    """One train step's loss and gradients, as `train/steps.py::train_step`
    computes them (the optimizer update left out), with its wall time and
    the peak memory it allocated above what was allocated before it (the
    weights and the earlier runs' gradients)."""
    import torch
    from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
    from multimodal_sequencing_tpu_torch.train.steps import (compute_loss,
                                                             device_batch)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    db = device_batch(batch, "cuda")
    out = model(db["input_ids"], db["attention_mask"], db["token_type_ids"],
                deterministic=False, rng=DropoutRng(seed + 1, step, "cuda"))
    loss, _ = compute_loss(model.cfg, out, db)
    loss.backward()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = (torch.cuda.max_memory_allocated() - start) / 2**30
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {"loss": loss.detach().float(), "grads": grads, "wall_ms": wall_ms,
            "peak_gib": peak_gib}


def phase_remat(seed: int):
    """A full-width train step (B = 8, S = 320, dropout 0.1) with
    `EncoderConfig.remat` on and off, from the same weights and (seed,
    step), in turns: the loss bit-equal in f32, and every gradient as close
    to the no-remat one as two no-remat runs are to each other (the flash
    backward adds dq's partials in no fixed order, so gradients are not
    bit-stable from run to run). The gradients no dq feeds (the head's, and
    the last layer's but its query projection's) must be bit-equal."""
    import torch
    b, _, s, _ = TRAIN_SHAPE
    cfg, model = _full_width_model(seed)
    model = model.cuda().train()
    batch = _random_batch(cfg, b, s, seed)
    step = 3
    runs = {}
    # the first remat run also pays the checkpoint machinery's first use
    for name, remat in (("remat_first", True), ("plain", False),
                        ("remat", True), ("plain_2", False),
                        ("remat_2", True)):
        model.encoder.cfg.remat = remat
        runs[name] = _loss_and_grads(model, batch, step, seed)
    # what remat is for: the activations of a larger batch (B = 32, the
    # eval micro-batch), beside the gradients that both runs hold; the
    # first run at this shape warms it up
    big = _random_batch(cfg, 4 * b, s, seed + 1)
    peak_b32 = {}
    for name, remat in (("warm_up", False), ("plain", False),
                        ("remat", True)):
        model.encoder.cfg.remat = remat
        run = _loss_and_grads(model, big, step, seed)
        peak_b32[name] = {"peak_memory_above_start_gib": run["peak_gib"],
                          "wall_ms": run["wall_ms"]}
        del run
    model.encoder.cfg.remat = False
    base = runs["plain"]["grads"]
    # each gradient's distance to the first no-remat run's, over that run's
    # global norm (as phase_train_reference measures it: the attention key
    # biases' gradients are zero but for rounding, so their own norms are
    # no scale)
    total = math.sqrt(sum(g.float().norm().item() ** 2 for g in base.values()))

    def rel(other):
        return {n: (other[n].float() - g.float()).norm().item() / total
                for n, g in base.items()}

    spread = rel(runs["plain_2"]["grads"])
    remats = ("remat_first", "remat", "remat_2")
    diffs = {name: rel(runs[name]["grads"]) for name in remats}
    last = f"encoder.layer_{cfg.encoder.num_hidden_layers - 1}."
    dq_free = sorted(n for n in base if n.startswith("heatmap_head.") or (
        n.startswith(last) and ".attention.query." not in n))
    spread_max = max(spread.values())
    # A remat run and a second no-remat run are draws of the same run-to-run
    # noise when remat replays the step, so a bound of one spread would
    # fail about half the time: the bound is twice the largest spread.
    tol = 2 * spread_max
    worst = {name: max(d.values()) for name, d in diffs.items()}
    dq_free_equal = all(torch.equal(runs[name]["grads"][n], base[n])
                        for name in remats + ("plain_2",) for n in dq_free)
    losses_equal = all(torch.equal(runs[name]["loss"], runs["plain"]["loss"])
                       for name in runs)
    summary = {
        "phase": "remat", "shape_bs": [b, s], "dropout": 0.1, "step": step,
        "losses": {k: r["loss"].item() for k, r in runs.items()},
        "losses_bit_equal": losses_equal,
        "grad_spread_no_remat_max_rel": spread_max,
        "grad_remat_max_rel": worst, "tol_rel": tol,
        "gradients": len(base), "dq_free_gradients": len(dq_free),
        "dq_free_bit_equal": dq_free_equal,
        "equal_in_both_plain_runs": sum(v == 0.0 for v in spread.values()),
        "equal_in_plain_runs_not_in_remat": sorted(
            n for n, v in spread.items() if v == 0.0
            and any(diffs[r][n] != 0.0 for r in remats)),
        "worst_spread": sorted(((v, n) for n, v in spread.items()),
                               reverse=True)[:3],
        "worst_remat": sorted(((v, n) for n, v in diffs["remat"].items()),
                              reverse=True)[:3],
        "wall_ms": {k: r["wall_ms"] for k, r in runs.items()},
        "peak_memory_above_start_gib": {k: r["peak_gib"]
                                        for k, r in runs.items()},
        "b32": peak_b32}
    emit(summary)
    if not (losses_equal and dq_free_equal
            and all(w <= tol for w in worst.values())):
        raise AssertionError(f"remat check failed: {summary}")


def _mm_model(seed, dtype="bfloat16", freeze=False, **enc):
    """The multimodal sequencer at full width: RoBERTa-large over the joint
    stream and the CLIP RN50 tower at 224 px, fresh weights from `seed`."""
    from multimodal_sequencing_tpu_torch.models.config import (
        CLIPVisionConfig, EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    cfg = MultimodalConfig(
        encoder=EncoderConfig.roberta_large(type_vocab_size=5, dtype=dtype,
                                            **enc),
        hierarchical_version="v1", max_seq_length=320, multimodal=True,
        clip_model_name="RN50", image_size=(MM_IMAGE, MM_IMAGE),
        freeze_vision_model=freeze)
    vcfg = CLIPVisionConfig.rn50(dtype=dtype)
    return cfg, init_weights(SequencingModel(cfg, vcfg), seed)


def _random_images(b, seed):
    """(b, 5, 224, 224, 3) uint8 step images, as the loader ships them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 5, MM_IMAGE, MM_IMAGE, 3), dtype=np.uint8)


def _bn_stats(model):
    return {n: b.detach().double().cpu() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _rel_to_max(got, want):
    """max |got - want| over max |want| (0 when both are 0)."""
    scale = want.abs().max().item()
    err = (got.double().cpu() - want.double().cpu()).abs().max().item()
    return err / scale if scale else err


# mm_check: the eval output and the BatchNorm statistics, card against CPU
# in f32 without TF32 (f32 sums in another order through ~55 conv and
# BatchNorm layers), relative to each tensor's largest entry. The
# train-mode output and the gradients are ill-conditioned in f32 (the fast
# variance E[x^2] - E[x]^2 of batch statistics; the CPU's own f32 gradients
# of the stem convs are ~1 % of the global norm off an f64 run), so the
# card is held to the f64 run instead: its distance at most MM_F32_FACTOR
# times the CPU's f32 distance, plus MM_TOWER_TOL, for the output, the
# gradients over their global norm and each gradient over its own norm
# (card over CPU at most 1.70 over seeds 0-3). And the same tower in f64 on
# the card against the f64 run on the CPU: every output, statistic and
# gradient within MM_F64_TOL of its own largest entry or norm (at most
# 8.5e-13 over seeds 0-3).
MM_TOWER_TOL = 1e-4
MM_F32_FACTOR = 4
MM_F64_TOL = 1e-8


def _pool_attention_f64(q, k, v, mask=None, dropout_p=0.0, seed=None):
    """The attention pool's attention (no mask, no dropout) in f64, for the
    f64 runs (the port's kernels and plain version take f32 and bf16)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v)


def phase_mm_check(seed: int):
    """The full-width CLIP RN50 tower at 224 px on the card against the CPU
    (plain versions), f32, on the same weights and the same 2 stories x 5
    random uint8 images: a train-mode forward (batch statistics; the
    running averages it updates) and its backward from a random projection
    of the output, then an eval forward on the updated averages. An f64 run
    of the same tower on the CPU measures how far each f32 run is from the
    exact result, and an f64 run on the card (convs, BatchNorms, the pool's
    projections and fold; its attention by SDPA, which kernel_check holds
    at this shape) is held to it gradient by gradient."""
    import copy
    import torch
    from multimodal_sequencing_tpu_torch.models import clip_visual
    from multimodal_sequencing_tpu_torch.models.config import CLIPVisionConfig
    from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
    from multimodal_sequencing_tpu_torch.ops.preprocess import images_to_nchw
    cpu = init_weights(clip_visual.CLIPVisualTower(CLIPVisionConfig.rn50()),
                       seed)
    card = copy.deepcopy(cpu).cuda()
    f64 = clip_visual.CLIPVisualTower(CLIPVisionConfig.rn50(dtype="float64"))
    f64.load_state_dict(cpu.state_dict())
    f64.double()
    card64 = copy.deepcopy(f64).cuda()
    x = images_to_nchw(torch.from_numpy(_random_images(2, seed)))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randn((2, MM_VISUAL_TOKENS, 2048), generator=gen)

    def run(model, dev, dtype):
        out = model(x.to(dev, dtype), img_len=5, deterministic=False)
        (out * w.to(dev, dtype)).sum().backward()
        with torch.no_grad():
            ev = model(x.to(dev, dtype), img_len=5)
        return {"train_output": out.detach().double().cpu(),
                "eval_output": ev.double().cpu(), "stats": _bn_stats(model),
                "grads": {n: p.grad.double().cpu()
                          for n, p in model.named_parameters()}}

    res = {"cpu": run(cpu, "cpu", torch.float32),
           "cuda": run(card, "cuda", torch.float32)}
    real = clip_visual.multihead_attention
    clip_visual.multihead_attention = _pool_attention_f64
    try:
        res["f64"] = run(f64, "cpu", torch.float64)
        res["cuda_f64"] = run(card64, "cuda", torch.float64)
    finally:
        clip_visual.multihead_attention = real
    exact = res["f64"]["grads"]
    total = math.sqrt(sum(g.norm().item() ** 2 for g in exact.values()))
    # the pool's key bias: softmax is invariant to it, so its exact
    # gradient is 0 and it is measured against the global norm alone
    own = {n: total if n.endswith("k_proj.bias") else g.norm().item()
           for n, g in exact.items()}

    def grad_dist(name):  # the worst gradient's distance over the global norm
        return max((g - exact[n]).norm().item() / total
                   for n, g in res[name]["grads"].items())

    def leaf_dist(name):  # each gradient's distance over its own f64 norm
        return {n: (g - exact[n]).norm().item() / own[n]
                for n, g in res[name]["grads"].items()}

    direct = {
        "eval_output": _rel_to_max(res["cuda"]["eval_output"],
                                   res["cpu"]["eval_output"]),
        "bn_stats": max(_rel_to_max(res["cuda"]["stats"][n], want)
                        for n, want in res["cpu"]["stats"].items())}
    to_f64 = {name: {"train_output": _rel_to_max(
        res[name]["train_output"], res["f64"]["train_output"]),
        "grads": grad_dist(name)} for name in ("cpu", "cuda")}
    bounds = {k: MM_F32_FACTOR * v + MM_TOWER_TOL
              for k, v in to_f64["cpu"].items()}
    leaves = {name: leaf_dist(name) for name in ("cpu", "cuda", "cuda_f64")}
    f64_card = {k: _rel_to_max(res["cuda_f64"][k], res["f64"][k])
                for k in ("train_output", "eval_output")}
    f64_card["bn_stats"] = max(_rel_to_max(res["cuda_f64"]["stats"][n], want)
                               for n, want in res["f64"]["stats"].items())
    f64_card["grads_own_norm"] = max(leaves["cuda_f64"].values())
    # each gradient over its own norm: the card's f32 distance to f64
    # against its bound from the CPU's
    leaf_over = sorted(((leaves["cuda"][n] - MM_F32_FACTOR * leaves["cpu"][n]
                         - MM_TOWER_TOL, n) for n in own), reverse=True)
    moved = max((st - (0.0 if n.endswith("mean") else 1.0)).abs().max().item()
                for n, st in res["cpu"]["stats"].items())
    ok = (tuple(res["cuda"]["eval_output"].shape)
          == (2, MM_VISUAL_TOKENS, 2048)
          and all(v <= MM_TOWER_TOL for v in direct.values())
          and all(to_f64["cuda"][k] <= bounds[k] for k in bounds)
          and leaf_over[0][0] <= 0
          and all(v <= MM_F64_TOL for v in f64_card.values())
          and bool(torch.isfinite(res["cuda"]["eval_output"]).all())
          and moved > 0)

    def worst(d, n=5):
        return sorted(((v, k) for k, v in d.items()), reverse=True)[:n]

    ratio = {n: leaves["cuda"][n] / leaves["cpu"][n] for n in own
             if leaves["cpu"][n] > 0}
    emit({"phase": "mm_check", "tower": "RN50", "image": MM_IMAGE,
          "images": [2, 5], "dtype": "float32",
          "output_shape": list(res["cuda"]["eval_output"].shape),
          "card_vs_cpu_rel_to_max": direct, "tol": MM_TOWER_TOL,
          "distance_to_f64": to_f64, "bounds_to_f64": bounds,
          "f64_card_vs_cpu": f64_card, "f64_tol": MM_F64_TOL,
          "grads_to_f64_own_norm_worst": {k: worst(v) for k, v in
                                          leaves.items()},
          "grads_f32_card_over_cpu_own_norm_worst": worst(ratio),
          "grads_f32_card_minus_bound_own_norm_worst": leaf_over[:3],
          "f64_grad_global_norm": total, "bn_buffers": len(res["cpu"]["stats"]),
          "bn_stats_max_move": moved, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the RN50 tower")


def phase_mm_reference(seed: int):
    """The joint sequencer at full width with 2 layers, f32, dropout 0, card
    (kernels) against the CPU (plain versions) on the same weights, packed
    ids and images: the forward heat map, then four train steps (losses,
    grad norms, the first step's gradients, the BatchNorm statistics after
    every step, and the weights after three updates of nonzero learning
    rate), as `reference` and `train_reference` hold the text sequencer.
    The steps train with `freeze_vision_model`: the tower's own gradients
    are ill-conditioned in f32 (phase `mm_check` holds them to an f64 run),
    and would move the two runs apart by more than rounding after one
    update; its statistics still update, and its weights still decay.
    cuDNN is asked for deterministic algorithms here."""
    import copy
    import torch
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import train_step
    lr, n_steps, b = 1e-3, 4, 2
    cfg, cpu_model = _mm_model(seed, dtype="float32", freeze=True,
                               num_hidden_layers=2, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    init = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    card_model = copy.deepcopy(cpu_model).cuda()
    batches = []
    for i in range(n_steps):
        bt = _random_batch(cfg, b, 320, seed + i)
        bt["images"] = _random_images(b, seed + 10 + i)
        batches.append(bt)
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            ids, am, tt = (torch.from_numpy(batches[0][k]).long() for k in
                           ("input_ids", "attention_mask", "token_type_ids"))
            img = torch.from_numpy(batches[0]["images"])
            want = cpu_model.eval()(ids, am, tt, img)["heatmap"]
            got = card_model.eval()(ids.cuda(), am.cuda(), tt.cuda(),
                                    img.cuda())["heatmap"].cpu()
        hm_err = (got - want).abs().max().item()
        hist, grads, stats = {}, {}, {}
        for name, model in (("cpu", cpu_model), ("cuda", card_model)):
            opt = AdamW(model, learning_rate=lr, warmup_steps=1,
                        total_steps=10, weight_decay=0.01)
            hist[name], stats[name] = [], []
            for i, bt in enumerate(batches):
                hist[name].append({k: float(v) for k, v in train_step(
                    model.train(), opt, bt, i, seed).items()})
                stats[name].append(_bn_stats(model))
                if i == 0:
                    grads[name] = {n: p.grad.detach().double().cpu()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}
    finally:
        torch.backends.cudnn.deterministic = False
    total = math.sqrt(sum(g.norm().item() ** 2 for g in grads["cpu"].values()))
    grad_rel = sorted(((grads["cuda"][n] - g).norm().item() / total, n)
                      for n, g in grads["cpu"].items())[::-1]
    tower_grads = [n for g in grads.values() for n in g
                   if ".visual_model." in n]
    stat_err = max(_rel_to_max(c[n], w[n]) for c, w in
                   zip(stats["cuda"], stats["cpu"]) for n in w)
    card_params = dict(card_model.named_parameters())
    w_err = {"key_bias": 0.0, "other": 0.0}
    worst_w = []
    moved = 0.0
    for n, p in cpu_model.named_parameters():
        # attention key biases: softmax is invariant to them, so their
        # gradient is zero but for rounding (the joint layers' and the
        # attention pool's)
        kind = "key_bias" if n.endswith(("key.bias", "k_proj.bias")) \
            else "other"
        err = (card_params[n].detach().cpu() - p.detach()).abs().max().item()
        w_err[kind] = max(w_err[kind], err)
        worst_w.append((err, n))
        if kind == "other":
            moved = max(moved, (p.detach() - init[n]).abs().max().item())
    rel = lambda a, c: abs(a - c) / max(abs(c), 1e-12)  # noqa: E731
    loss_err = max(rel(g["loss"], w["loss"])
                   for g, w in zip(hist["cuda"], hist["cpu"]))
    gn_err = max(rel(g["grad_norm"], w["grad_norm"])
                 for g, w in zip(hist["cuda"], hist["cpu"]))
    # Limits of about 2.5-3x the largest reading over seeds 0-3 (two runs
    # each, bit-equal; my card runs): loss 1.00e-5, grad norm 1.06e-5, worst
    # gradient over the global norm 1.08e-5 (the text phase's 1e-5 leaves
    # no margin: the frozen tower's train-mode output, whose batch
    # statistics are ill-conditioned in f32 (mm_check), differs by ~1e-4
    # between card and CPU and feeds the joint layers); BatchNorm
    # statistics 5.9e-6 of each buffer's largest entry, after every step;
    # heat map 6.6e-7. Weights: Adam turns entries whose gradient sits at
    # that noise into steps of a fraction of lr either way (readings 1.08e-4
    # to 3.41e-4, in visn_fc, the word embeddings and the head), so the
    # weights are held at lr, a third of the largest move (2.68e-3)
    tol = {"heatmap_abs": 2e-4, "loss_rel": 3e-5, "grad_norm_rel": 3e-5,
           "grad_rel_to_norm": 3e-5, "bn_stats_rel": 1.5e-5,
           "weight_abs": lr, "key_bias_abs": 2 * lr * (n_steps - 1),
           "min_weight_move": 2 * lr}
    ok = (not tower_grads and hm_err <= tol["heatmap_abs"]
          and loss_err <= tol["loss_rel"]
          and gn_err <= tol["grad_norm_rel"]
          and grad_rel[0][0] <= tol["grad_rel_to_norm"]
          and stat_err <= tol["bn_stats_rel"]
          and w_err["other"] <= tol["weight_abs"]
          and w_err["key_bias"] <= tol["key_bias_abs"]
          and moved >= tol["min_weight_move"])
    emit({"phase": "mm_reference", "layers": 2, "dtype": "float32",
          "stories": b, "joint_s": MM_JOINT_S, "steps": n_steps,
          "freeze_vision_model": True, "tower_grads": len(tower_grads),
          "heatmap_max_abs_err": hm_err, "history": hist,
          "loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
          "bn_stats_rel_err": stat_err, "max_abs_weight_err": w_err,
          "max_abs_weight_move": moved, "worst_grad_rel_err": grad_rel[:5],
          "worst_weight_err": sorted(worst_w, reverse=True)[:6],
          "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the joint sequencer")


def _mm_train_argv(data_dir, out_dir, seed):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--do_train", "--multimodal",
            "--multimodal_model_type", "clip", "--clip_model_name", "RN50",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_train_batch_size", "8",
            "--learning_rate", "1e-5", "--warmup_steps", "2",
            "--max_steps", str(MM_STEPS), "--logging_steps", "1",
            "--save_steps", "0", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda"]


def phase_mm_path(seed: int, work: str):
    """The multimodal CLIP-RN50 path through the CLIs at full width on the
    card: `main_train --multimodal` for 8 steps of 8 stories with 5 PNG step
    images each (dropout 0.1), then `run_eval --sort_method heat_map` on its
    checkpoint over 40 stories with host decode and with
    `--device_decode`. Every flash forward (24 joint + the attention pool a
    forward) and, in training, every backward must be a kernel launch."""
    import torch
    from multimodal_sequencing_tpu_torch.data import images
    from multimodal_sequencing_tpu_torch.train.cli import main_train, run_eval
    data_dir = os.path.join(work, "mm_data")
    out_dir = os.path.join(work, "mm_out")
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    written = {
        "train": write_wikihow(data_dir, "train", 8 * MM_STEPS, seed + 4,
                               images=True),
        "test": write_wikihow(data_dir, "test", N_STORIES, seed + 5,
                              images=True)}
    write_s = time.perf_counter() - t0
    # the decoder `read_image_rgb` tries first, and whether each step image
    # reads back as written; without a decoder every image is zeros
    decoder = None
    for module in ("cv2", "PIL.Image"):
        try:
            __import__(module)
        except ImportError:
            continue
        decoder = module.split(".")[0]
        break

    def image_counts(split):
        """Step images of `split` written, missing (the loader's
        missing_images file), read back as written, and zero-filled."""
        with open(os.path.join(data_dir, f"missing_images_{split}.txt")) as f:
            missing = sum(1 for line in f if line.strip())
        decoded = 0
        if decoder is not None:
            for path, rgb in written[split].items():
                try:
                    decoded += bool((images.read_image_rgb(path) == rgb).all())
                except Exception:
                    pass
        n = len(written[split])
        return {"written": n, "missing": missing, "decoded": decoded,
                "zeroed": n - decoded}

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = main_train(_mm_train_argv(data_dir, out_dir, seed))
    wall_s = time.perf_counter() - t0
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in res.history]
    times = [h["time"] for h in res.history]
    step_s = [b - a for a, b in zip([res.start_time] + times[:-1], times)]
    med = _median_after_first(step_s)
    ckpt = os.path.join(out_dir, f"checkpoint-{res.global_step}")
    train_images = image_counts("train")
    summary = {
        "phase": "mm_path", "part": "train", "steps": res.global_step,
        "decoder": decoder, "train_images": train_images,
        "png_write_s": write_s, "launches": counts, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in res.history],
        "step_s": step_s, "median_step_s_after_first": med,
        "stories_per_s": 8 / med, "peak_memory_gib": peak_gb,
        "wall_s_incl_init": wall_s, "checkpoint": os.path.basename(ckpt)}
    emit(summary)
    ok = (res.global_step == MM_STEPS
          and all(math.isfinite(x) for x in losses) and len(set(losses)) > 1
          and all(counts[k] == MM_STEPS * MM_PER_FORWARD[k]
                  for k in PATH_KERNELS["mm_train"])
          and all(counts[k] == 0 for k in F32_BWD)
          and train_images["missing"] == 0
          and (decoder is None
               or train_images["decoded"] == 8 * MM_STEPS * 5)
          and os.path.isfile(os.path.join(ckpt, "vision_config.json")))
    if not ok:
        raise AssertionError(f"multimodal train check failed: {summary}")
    eval_counts = {}
    for name, extra in (("host", []), ("device", ["--device_decode"])):
        ev_dir = os.path.join(work, f"mm_eval_{name}")
        _reset_counts()
        results, evaluator = run_eval(_eval_argv(
            data_dir, ev_dir, seed, "--multimodal", *extra, model=ckpt))
        eval_counts[name] = _read_counts()
        fwd, dec = evaluator.forward_seconds, evaluator.decode_seconds
        batches = math.ceil(N_STORIES / 8)
        perms = _check_eval_outputs(ev_dir, N_STORIES)
        summary = {
            "phase": "mm_path", "part": f"eval_{name}_decode",
            "stories": N_STORIES, "forwards": evaluator.forwards,
            "images": image_counts("test"),
            "launches": eval_counts[name], "all_permutations": perms,
            "median_batch_s": _median_after_first(
                [f + d for f, d in zip(fwd, dec)]),
            "median_forward_s": _median_after_first(fwd),
            "median_decode_s": _median_after_first(dec),
            "metrics": results["test"]}
        emit(summary)
        if not (perms and evaluator.forwards == batches
                and summary["images"]["missing"] == 0
                and (decoder is None
                     or summary["images"]["decoded"] == N_STORIES * 5)
                and all(eval_counts[name][k] == batches * MM_PER_FORWARD[k]
                        for k in PATH_KERNELS["mm_eval"])):
            raise AssertionError(f"multimodal eval check failed: {summary}")
    return {"mm_train": counts, "mm_eval": eval_counts["host"]}


# the multimodal eval forward's parts timed apart, by module class
MM_PARTS = (("tower", "CLIPVisualTower"), ("batch_norm", "BatchNorm"),
            ("attnpool", "AttentionPool2d"))


def phase_mm_breakdown(seed: int):
    """Device time of one warm multimodal train step (B = 8, 5 images a
    story, joint S = 566, dropout 0.1) and one warm eval forward (B = 32) at
    full width, bf16, by kernel class (convs apart); and, for the eval
    forward, which keeps the card busy, the card time of its tower,
    BatchNorm and attention-pool calls, from CUDA events the script
    records around each call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_sequencing_tpu_torch.models import clip_visual
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        cast_for_inference)
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import train_step
    originals, events = {}, {label: [] for label, _ in MM_PARTS}
    timed = [False]
    for label, cls_name in MM_PARTS:
        cls = getattr(clip_visual, cls_name)
        originals[cls] = cls.forward

        def part(self, *a, _f=cls.forward, _l=label, **kw):
            if not timed[0]:
                return _f(self, *a, **kw)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = _f(self, *a, **kw)
            end.record()
            events[_l].append((start, end))
            return out

        cls.forward = part
    classes = (CONV_CLASS,) + KERNEL_CLASSES

    def by_class(prof, wall_ms):
        out = {name: 0.0 for name, _ in classes}
        out["other"] = 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            key = evt.key.lower()
            cls = next((n for n, pats in classes
                        if any(p in key for p in pats)), "other")
            out[cls] += evt.self_device_time_total / 1e3
        busy = sum(out.values())
        return {"device_ms_by_class": out, "device_busy_ms": busy,
                "device_busy_share": busy / wall_ms}

    try:
        cfg, model = _mm_model(seed)
        model = model.cuda().train()
        opt = AdamW(model, learning_rate=1e-5, warmup_steps=2,
                    total_steps=100)
        batch = _random_batch(cfg, 8, 320, seed)
        batch["images"] = _random_images(8, seed)
        step = [0]

        def one():
            out = train_step(model, opt, batch, step[0], seed)
            step[0] += 1
            return out

        step_ms = cuda_ms(one, iters=3, warmup=2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        emit({"phase": "mm_breakdown", "path": "train step",
              "stories": 8, "joint_s": MM_JOINT_S, "step_ms": step_ms,
              **by_class(prof, step_ms)})
        del opt
        model = cast_for_inference(model).eval()
        ev = _random_batch(cfg, 32, 320, seed + 1)
        ids, am, tt = (torch.from_numpy(ev[k]).long().cuda() for k in
                       ("input_ids", "attention_mask", "token_type_ids"))
        img = torch.from_numpy(_random_images(32, seed + 1)).cuda()
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: model(ids, am, tt, img), iters=5)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(ids, am, tt, img)
                torch.cuda.synchronize()
            timed[0] = True
            model(ids, am, tt, img)
            torch.cuda.synchronize()
            timed[0] = False
        parts = {label: sum(a.elapsed_time(b) for a, b in evs)
                 for label, evs in events.items()}
        emit({"phase": "mm_breakdown", "path": "eval forward",
              "stories": 32, "joint_s": MM_JOINT_S, "forward_ms": forward_ms,
              "part_ms_by_cuda_events": parts,
              "part_calls": {k: len(v) for k, v in events.items()},
              **by_class(prof, forward_ms)})
    finally:
        for cls, fwd in originals.items():
            cls.forward = fwd


# ----- BERSON ---------------------------------------------------------------


def _berson_model(seed, multimodal=False, layers=24, dtype="bfloat16",
                  freeze=False, **enc):
    """BERSON at full width (RoBERTa-large inner, hidden 1024, 16 heads of
    64; the head's paragraph encoder 8 heads of 128 and FF 3072; LSTM 1024)
    over the text encoder or the CLIP-RN50 joint encoder at 224 px, fresh
    weights from `seed`."""
    from multimodal_sequencing_tpu_torch.models.berson import BersonOrdering
    from multimodal_sequencing_tpu_torch.models.config import (
        CLIPVisionConfig, EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
    kw = dict(multimodal=True, clip_model_name="RN50",
              image_size=(MM_IMAGE, MM_IMAGE),
              freeze_vision_model=freeze) if multimodal else {}
    cfg = MultimodalConfig(
        encoder=EncoderConfig.roberta_large(num_hidden_layers=layers,
                                            dtype=dtype, **enc),
        max_seq_length=320, per_seq_max_length=BERSON_L // 2,
        wrapper_model_type="berson", **kw)
    vcfg = CLIPVisionConfig.rn50(dtype=dtype) if multimodal else None
    return cfg, init_weights(BersonOrdering(cfg, vcfg), seed)


def _berson_batch(seed, lens, images=False):
    """A collated batch of BERSON's packed pairs for stories of `lens`
    steps (of 5; steps of 10..70 random words), with each story's (5, 224,
    224, 3) uint8 step images when asked (zeros past its length)."""
    import numpy as np
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    rng = np.random.default_rng(seed)
    packer = StoryPacker(SimpleWordTokenizer(), 320, BERSON_L // 2)
    items = [packer.pack_berson_story(
        [" ".join(rng.choice(WORDS, size=int(rng.integers(10, 71))))
         for _ in range(m)], rng.permutation(m).tolist(), max_story_length=5)
        for m in lens]
    batch = {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}
    batch["valid"] = np.ones(len(lens), bool)
    if images:
        img = _random_images(len(lens), seed + 1)
        for i, m in enumerate(lens):
            img[i, m:] = 0
        batch["images"] = img
    return batch


def _chain_scores(model, db, orders):
    """Each story's beam score of `orders` ((B, 5), -1 past a story's
    length) under `model`'s pointer logits: the sum over its first m - 1
    steps of the log-softmax at the chosen step, teacher-forced along the
    order, in f64."""
    import torch
    n = orders.shape[1]
    m = (orders >= 0).sum(1)
    gt = orders.clone()
    for i in range(len(gt)):
        gt[i, m[i]:] = torch.arange(int(m[i]), n)
    with torch.inference_mode():
        logits = model({**db, "ground_truth": gt.to(db["input_ids"].device)}
                       )["pointer_logits"].double().cpu()
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(2, gt[:, :, None].cpu())[..., 0]
    steps = torch.arange(n)[None] < (m[:, None] - 1)
    return (picked * steps).sum(1)


# berson_reference: the encode() intermediates and the pointer logits, card
# (f32, kernels) against the CPU (plain versions), each within
# BERSON_FWD_TOL of its largest entry, the sequencer's forward limit; two
# beam orders that differ must tie: their scores under either side's
# logits within BERSON_TIE_ABS (sums of four log-probabilities, f32 logits
# ~1e-5 apart). The train steps as train_reference / mm_reference.
BERSON_FWD_TOL = 2e-4
BERSON_TIE_ABS = 1e-4
BERSON_ENC_KEYS = ("doc", "key", "cls_score", "cls_output_matrix",
                   "cls_score_matrix", "his1_matrix", "his2_matrix")
# The train steps run along the CPU's trajectory: before each step the
# card's model and AdamW take the CPU's weights, statistics and moments, so
# each step's readings are one step's disagreement and Adam does not
# compound rounding. One update's weights are held two ways. (1) Against
# the CPU's AdamW applied to the card's own gradients from the same state:
# the card's update alone, elementwise f32 rounding, within lr * 1e-3 for
# every parameter. (2) Against the CPU's weights: the gradients' card-CPU
# distance and the update together. Adam divides each entry's step by its
# own gradient scale, so where an entry's gradients sit near that distance
# the step differs by a fraction of lr. A parameter whose CPU gradient is
# below f32's unit roundoff (2^-24) of the global norm cannot be told from
# rounding (the biases a softmax is invariant to: the attention keys', the
# token-span scores', the pointer logits'); its direction is not
# determined, and Adam steps it by up to ~1.001 lr_t either way
# (|m_hat| / sqrt(v_hat) at counts <= 4), so in (2) it is held to two such
# steps.
BERSON_UNDETERMINED_GRAD = 2.0 ** -24
BERSON_UNDETERMINED_STEPS = 2.01
BERSON_UPDATE_TOL = 1e-3  # of lr


def _berson_reference(seed, multimodal):
    import copy
    import torch
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import (
        berson_train_step, device_batch)
    lr, n_steps = 1e-3, 4
    lens = [4] if multimodal else [5, 3]
    cfg, cpu_model = _berson_model(
        seed, multimodal, layers=2, dtype="float32", freeze=multimodal,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cpu_model.para_encoder.dropout = 0.0  # its own 0.1 otherwise
    init = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    card_model = copy.deepcopy(cpu_model).cuda()
    batches = [_berson_batch(seed + i, lens, multimodal)
               for i in range(n_steps)]
    models = {"cpu": cpu_model.eval(), "cuda": card_model.eval()}
    dbs = {name: device_batch(batches[0], name) for name in models}
    enc, fwd, orders = {}, {}, {}
    with torch.inference_mode():
        for name, model in models.items():
            enc[name] = model.encode(dbs[name])
            fwd[name] = model(dbs[name])
            orders[name] = model.beam_search(dbs[name], enc[name]).cpu()
    enc_err = {k: _rel_to_max(enc["cuda"][k], enc["cpu"][k])
               for k in BERSON_ENC_KEYS}
    enc_err["h"] = _rel_to_max(enc["cuda"]["hcn"][0], enc["cpu"]["hcn"][0])
    logits = {n: f["pointer_logits"].cpu() for n, f in fwd.items()}
    masked = logits["cpu"] == -1e9
    enc_err["pointer_logits"] = _rel_to_max(logits["cuda"][~masked],
                                            logits["cpu"][~masked])
    masked_equal = torch.equal(logits["cuda"] == -1e9, masked)
    loss_fwd_err = abs(fwd["cuda"]["loss"].item() - fwd["cpu"]["loss"].item()
                       ) / abs(fwd["cpu"]["loss"].item())
    ties = []
    differ = ~(orders["cuda"] == orders["cpu"]).all(1)
    if bool(differ.any()):
        for name, model in models.items():
            a = _chain_scores(model, dbs[name], orders["cuda"])
            b = _chain_scores(model, dbs[name], orders["cpu"])
            ties.append((a - b).abs()[differ].max().item())
    lengths_ok = all(sorted(o[:m].tolist()) == list(range(m))
                     and bool((o[m:] == -1).all())
                     for o, m in zip(orders["cuda"], lens))

    # The text and joint sequencers' limits (train_reference, mm_reference),
    # moved where the readings along the CPU's trajectory (seeds 0-3 on
    # an H100, bit-equal run to run; PERF.md) came near them. Text: loss,
    # grad norm and gradients <= 1.36e-6 (1e-5 kept); one update's weights
    # <= 1.84e-5, held at lr / 10. Clip inner: its frozen tower's
    # train-mode output is ~1e-4 apart between card and CPU in f32
    # (mm_check) and feeds the 99 visual tokens of every pair: gradients
    # <= 4.52e-5 of the global norm (1.2e-4 for 3e-5), grad norm 7.06e-5
    # (2e-4 for 3e-5), statistics 1.14e-5 (3e-5 for 1.5e-5), and one
    # update's weights 1.61e-4..3.76e-4 against the CPU's (Adam's division
    # above, at the first update, whose moments hold one earlier gradient),
    # held at lr; (1) holds the card's update itself
    if multimodal:
        tol = {"loss_rel": 3e-5, "grad_norm_rel": 2e-4,
               "grad_rel_to_norm": 1.2e-4, "bn_stats_rel": 3e-5,
               "weight_abs": lr}
    else:
        tol = {"loss_rel": 1e-5, "grad_norm_rel": 1e-5,
               "grad_rel_to_norm": 1e-5, "bn_stats_rel": 0.0,
               "weight_abs": lr / 10}
    tol.update(forward_rel_to_max=BERSON_FWD_TOL, tie_abs=BERSON_TIE_ABS,
               update_abs=BERSON_UPDATE_TOL * lr, min_weight_move=2 * lr,
               undetermined_grad_rel=BERSON_UNDETERMINED_GRAD,
               undetermined_lr_steps=BERSON_UNDETERMINED_STEPS)
    replay = copy.deepcopy(cpu_model)  # the CPU's AdamW on card gradients
    opts = {name: AdamW(model, learning_rate=lr, warmup_steps=1,
                        total_steps=10, weight_decay=0.01)
            for name, model in {**models, "replay": replay}.items()}
    replay_params = dict(replay.named_parameters())
    card_params = dict(card_model.named_parameters())
    rel = lambda a, c: abs(a - c) / max(abs(c), 1e-12)  # noqa: E731
    hist, grads = {"cpu": [], "cuda": []}, {}
    loss_err = gn_err = stat_err = 0.0
    grad_rel, w_err, worst_w = [], {"undetermined": 0.0, "other": 0.0}, []
    update_err = (0.0, "", -1)
    undetermined, tower_grads, smallest = set(), set(), []
    for i, bt in enumerate(batches):
        for name, model in (("cuda", card_model), ("replay", replay)):
            model.load_state_dict(cpu_model.state_dict())
            opts[name].load_state_dict(opts["cpu"].state_dict())
        lr_t = opts["cpu"].schedule(opts["cpu"].count)
        for name, model in models.items():
            hist[name].append({k: float(v) for k, v in berson_train_step(
                model, opts[name], bt, i, seed).items()})
            grads[name] = {n: p.grad.detach().double().cpu()
                           for n, p in model.named_parameters()
                           if p.grad is not None}
            tower_grads.update(n for n in grads[name]
                               if ".visual_model." in n)
        for n, p in replay.named_parameters():
            p.grad = grads["cuda"][n].float() if n in grads["cuda"] else None
        opts["replay"].step(opts["replay"].grads())
        update_err = max([update_err] + [
            ((card_params[n].detach().cpu() - replay_params[n].detach())
             .abs().max().item(), n, i) for n in card_params])
        loss_err = max(loss_err, rel(hist["cuda"][i]["loss"],
                                     hist["cpu"][i]["loss"]))
        gn_err = max(gn_err, rel(hist["cuda"][i]["grad_norm"],
                                 hist["cpu"][i]["grad_norm"]))
        total = math.sqrt(sum(g.norm().item() ** 2
                              for g in grads["cpu"].values()))
        grad_rel = max(grad_rel, sorted(
            (((grads["cuda"][n] - g).norm().item() / total, n, i)
             for n, g in grads["cpu"].items()), reverse=True)[:5])
        smallest.append(sorted((g.norm().item() / total, n)
                               for n, g in grads["cpu"].items())[:8])
        want, got = _bn_stats(cpu_model), _bn_stats(card_model)
        stat_err = max([stat_err] + [_rel_to_max(got[n], w)
                                     for n, w in want.items()])
        # each parameter after this step's update; an undetermined one's
        # error in units of its two Adam steps
        for n, p in cpu_model.named_parameters():
            g = grads["cpu"].get(n)
            free = g is None or g.norm().item() <= (
                BERSON_UNDETERMINED_GRAD * total)
            err = (card_params[n].detach().cpu() - p.detach()).abs().max(
                ).item()
            if free:  # the frozen tower has no gradient
                undetermined.update([n] if g is not None else [])
                err /= BERSON_UNDETERMINED_STEPS * max(lr_t, 1e-30)
            w_err["undetermined" if free else "other"] = max(
                w_err["undetermined" if free else "other"], err)
            worst_w.append((err, n, i, free))
    moved = max((p.detach() - init[n]).abs().max().item()
                for n, p in cpu_model.named_parameters()
                if n not in undetermined)
    ok = (all(e <= BERSON_FWD_TOL for e in enc_err.values()) and masked_equal
          and loss_fwd_err <= tol["loss_rel"] and lengths_ok
          and all(t <= BERSON_TIE_ABS for t in ties) and not tower_grads
          and loss_err <= tol["loss_rel"] and gn_err <= tol["grad_norm_rel"]
          and grad_rel[0][0] <= tol["grad_rel_to_norm"]
          and stat_err <= tol["bn_stats_rel"]
          and update_err[0] <= tol["update_abs"]
          and w_err["other"] <= tol["weight_abs"]
          and w_err["undetermined"] <= 1.0
          and moved >= tol["min_weight_move"])
    emit({"phase": "berson_reference",
          "inner": "clip_rn50_frozen" if multimodal else "text",
          "layers": 2, "dtype": "float32", "story_lengths": lens,
          "steps": n_steps, "forward_rel_err": enc_err,
          "masked_logits_equal": masked_equal, "loss_rel_err_eval": loss_fwd_err,
          "orders": {n: o.tolist() for n, o in orders.items()},
          "orders_differ": int(differ.sum()), "tie_score_gaps": ties,
          "history": hist, "loss_rel_err": loss_err,
          "grad_norm_rel_err": gn_err, "bn_stats_rel_err": stat_err,
          "max_abs_update_err": update_err,
          "max_abs_weight_err": w_err, "max_abs_weight_move": moved,
          "undetermined": sorted(undetermined),
          "smallest_cpu_grad_rel_to_norm": smallest,
          "tower_grads": len(tower_grads), "worst_grad_rel_err": grad_rel,
          "worst_weight_err": sorted((w for w in worst_w if not w[3]),
                                     reverse=True)[:5],
          "worst_undetermined": sorted((w for w in worst_w if w[3]),
                                       reverse=True)[:3],
          "tol": tol, "ok": ok})
    return ok


def phase_berson_reference(seed: int):
    """The 2-layer full-width BERSON, f32, card (kernels) against the CPU
    (plain versions) on the same weights and batches, each with a short
    story: the encode() intermediates, the pointer logits, the loss and the
    beam orders (equal up to ties), then four train steps (losses, grad
    norms, the first step's gradients, the weights after three updates);
    the text inner (2 stories of 5 and 3 steps), then the CLIP-RN50 inner
    with a frozen tower (a story of 4 steps; BatchNorm statistics after
    every step). Dropout 0, the paragraph encoder's too. cuDNN is asked for
    deterministic algorithms."""
    import torch
    torch.backends.cudnn.deterministic = True
    try:
        ok = [_berson_reference(seed, mm) for mm in (False, True)]
    finally:
        torch.backends.cudnn.deterministic = False
    if not all(ok):
        raise AssertionError(f"card and CPU disagree on BERSON: {ok}")


def _berson_train_argv(data_dir, out_dir, seed, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--do_train", "--task_name", "wikihow_hl_v1",
            "--wrapper_model_type", "berson", "--min_story_length", "3",
            "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", str(BERSON_L // 2),
            "--warmup_steps", "2", "--logging_steps", "1", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda", *extra]


def _berson_eval_argv(data_dir, out_dir, ckpt, batch, *extra):
    return ["--model_name_or_path", ckpt, "--model_size", "large",
            "--task_name", "wikihow_sort", "--sort_method", "berson",
            "--beam_size", "16", "--min_story_length", "3",
            "--data_dir", data_dir, "--eval_splits", "test",
            "--max_seq_length", "320", "--per_seq_max_length",
            str(BERSON_L // 2), "--per_gpu_eval_batch_size", str(batch),
            "--output_dir", out_dir, "--device", "cuda", *extra]


def _berson_steps(res):
    times = [h["time"] for h in res.history]
    return [b - a for a, b in zip([res.start_time] + times[:-1], times)]


def _berson_orders_ok(out_dir, lengths):
    """Every order of `output_order.txt` a permutation of its story's
    length (the -1 tail stripped)."""
    with open(os.path.join(out_dir, "output_order.txt")) as f:
        orders = [[int(x) for x in line.split()] for line in f]
    return len(orders) == len(lengths) and all(
        sorted(o) == list(range(m)) for o, m in zip(orders, lengths))


def _expected(per_forward, forwards, steps, names):
    """Exact launches: each forward kernel `forwards` times its per-forward
    count, each backward kernel `steps` times."""
    return {k: (steps if "bwd" in k else forwards) * per_forward[k]
            for k in names}


def _berson_counts_ok(counts, per_forward, names, forwards, steps):
    return all(counts[k] == v for k, v in
               _expected(per_forward, forwards, steps, names).items())


def _story_lengths(n, seed):
    """Step counts 3..5 of n stories: every third story shorter than 5."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [5 if a % 3 else int(rng.integers(3, 5)) for a in range(n)]


def phase_berson_path(seed: int, work: str):
    """BERSON through the CLIs at full width on the card. Text: `main_train
    --wrapper_model_type berson` for 8 steps of 2 stories (40 pair
    sequences of 120 tokens, dropout 0.1), then `run_eval --sort_method
    berson` (beam 16) of its checkpoint over 48 stories in batches of 16.
    The reference launcher's configuration (`scripts/wikihow_finetune.sh`:
    CLIP RN50 inner, batch 1, lr 5e-6): 4 steps with PNG step images, the
    final save, `--do_eval` of it, then `run_eval --sort_method berson --multimodal`
    of the last. Stories of 3-5 steps (dead pairs). Then a profile of a
    text train step and an eval batch (forward, beam loop) by kernel
    class. Every path must launch its kernels, in exact counts."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import main_train, run_eval
    data_dir = os.path.join(work, "berson_data")
    os.makedirs(data_dir)
    train_lens = _story_lengths(2 * BERSON_STEPS, seed + 6)
    test_lens = _story_lengths(BERSON_EVAL_STORIES, seed + 7)
    write_wikihow(data_dir, "train", len(train_lens), seed + 6,
                  steps_of=train_lens.__getitem__, words=(10, 71))
    write_wikihow(data_dir, "test", len(test_lens), seed + 7,
                  steps_of=test_lens.__getitem__, words=(10, 71))
    launches = {}

    # --- text ---------------------------------------------------------------
    out_dir = os.path.join(work, "berson_out")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = main_train(_berson_train_argv(
        data_dir, out_dir, seed, "--per_gpu_train_batch_size", "2",
        "--learning_rate", "1e-5", "--max_steps", str(BERSON_STEPS),
        "--save_steps", "0"))
    wall_s = time.perf_counter() - t0
    launches["berson_train"] = counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_s = _berson_steps(res)
    losses = [h["loss"] for h in res.history]
    ckpt = os.path.join(out_dir, f"checkpoint-{res.global_step}")
    summary = {"phase": "berson_path", "part": "text_train",
               "steps": res.global_step, "stories_a_step": 2,
               "pair_sequences_a_step": 2 * BERSON_P, "launches": counts,
               "losses": losses, "step_s": step_s,
               "median_step_s_after_first": _median_after_first(step_s),
               "peak_memory_gib": peak_gb, "wall_s_incl_init": wall_s}
    emit(summary)
    if not (res.global_step == BERSON_STEPS
            and all(math.isfinite(x) for x in losses)
            and _berson_counts_ok(counts, BERSON_PER_FORWARD,
                                  PATH_KERNELS["berson_train"],
                                  BERSON_STEPS, BERSON_STEPS)
            and all(counts[k] == 0 for k in F32_BWD)):
        raise AssertionError(f"BERSON train check failed: {summary}")
    ev_dir = os.path.join(work, "berson_eval")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    results, evaluator = run_eval(_berson_eval_argv(data_dir, ev_dir, ckpt,
                                                    16))
    launches["berson_eval"] = counts = _read_counts()
    fwd, dec = evaluator.forward_seconds, evaluator.decode_seconds
    batches = math.ceil(BERSON_EVAL_STORIES / 16)
    summary = {"phase": "berson_path", "part": "text_eval",
               "stories": BERSON_EVAL_STORIES, "batch": 16, "beam": 16,
               "forwards": evaluator.forwards, "launches": counts,
               "median_batch_s": _median_after_first(
                   [f + d for f, d in zip(fwd, dec)]),
               "median_forward_s": _median_after_first(fwd),
               "median_decode_s": _median_after_first(dec),
               "forward_s": fwd, "decode_s": dec,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "metrics": results["test"]}
    emit(summary)
    if not (evaluator.forwards == batches
            and _berson_orders_ok(ev_dir, test_lens)
            and _berson_counts_ok(counts, BERSON_PER_FORWARD,
                                  PATH_KERNELS["berson_eval"], batches, 0)):
        raise AssertionError(f"BERSON eval check failed: {summary}")
    _berson_breakdown(res.model, seed, "text", [5, 4],
                      [5] * 12 + [4, 3, 4, 3])
    del res

    # --- the launcher's configuration -----------------------------------------
    mm_train = _story_lengths(BERSON_MM_STEPS, seed + 8)
    mm_test = _story_lengths(BERSON_MM_EVAL_STORIES, seed + 9)
    mm_data = os.path.join(work, "berson_mm_data")
    os.makedirs(mm_data)
    write_wikihow(mm_data, "train", len(mm_train), seed + 8, images=True,
                  steps_of=mm_train.__getitem__, words=(10, 71))
    write_wikihow(mm_data, "test", len(mm_test), seed + 9, images=True,
                  steps_of=mm_test.__getitem__, words=(10, 71))
    out_dir = os.path.join(work, "berson_mm_out")
    launcher = ["--multimodal", "--multimodal_model_type", "clip",
                "--vision_model", "resnet50"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = main_train(_berson_train_argv(
        mm_data, out_dir, seed, *launcher, "--per_gpu_train_batch_size", "1",
        "--per_gpu_eval_batch_size", "1", "--learning_rate", "5e-6",
        "--order_criteria", "loose", "--do_not_load_optimizer",
        "--max_steps", str(BERSON_MM_STEPS), "--save_steps", "0",
        "--do_eval", "--eval_splits", "test",
        "--iters_to_eval", "best", str(BERSON_MM_STEPS)))
    launches["berson_mm_train"] = counts = _read_counts()
    step_s = _berson_steps(res)
    losses = [h["loss"] for h in res.history]
    # the forwards: the steps' and the --do_eval sweep's (6 stories a batch
    # of 1); the final checkpoint is the one save (the RecipeQA finetune
    # launcher evaluates at a save, keeps checkpoint-best and trains on)
    forwards = BERSON_MM_STEPS + BERSON_MM_EVAL_STORIES
    summary = {"phase": "berson_path", "part": "launcher_train",
               "steps": res.global_step, "stories_a_step": 1,
               "joint_s": BERSON_MM_S, "launches": counts, "losses": losses,
               "step_s": step_s,
               "median_step_s_after_first": _median_after_first(step_s),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "eval_results": res.eval_results}
    emit(summary)
    sweep = sorted(res.eval_results)
    if not (res.global_step == BERSON_MM_STEPS
            and all(math.isfinite(x) for x in losses)
            and sweep == [f"checkpoint-{BERSON_MM_STEPS}"]
            and _berson_counts_ok(counts, BERSON_MM_PER_FORWARD,
                                  PATH_KERNELS["berson_mm_train"],
                                  forwards, BERSON_MM_STEPS)
            and all(os.path.isfile(os.path.join(
                out_dir, f"eval_results_split_test_{t}.txt")) for t in sweep)):
        raise AssertionError(f"BERSON launcher train check failed: {summary}")
    ckpt = os.path.join(out_dir, f"checkpoint-{res.global_step}")
    _berson_breakdown(res.model, seed, "launcher", [5], [5], images=True)
    del res
    ev_dir = os.path.join(work, "berson_mm_eval")
    _reset_counts()
    results, evaluator = run_eval(_berson_eval_argv(
        mm_data, ev_dir, ckpt, 1, *launcher))
    launches["berson_mm_eval"] = counts = _read_counts()
    fwd, dec = evaluator.forward_seconds, evaluator.decode_seconds
    summary = {"phase": "berson_path", "part": "launcher_eval",
               "stories": len(mm_test), "batch": 1, "beam": 16,
               "forwards": evaluator.forwards, "launches": counts,
               "median_batch_s": _median_after_first(
                   [f + d for f, d in zip(fwd, dec)]),
               "median_forward_s": _median_after_first(fwd),
               "median_decode_s": _median_after_first(dec),
               "metrics": results["test"]}
    emit(summary)
    if not (evaluator.forwards == len(mm_test)
            and _berson_orders_ok(ev_dir, mm_test)
            and _berson_counts_ok(counts, BERSON_MM_PER_FORWARD,
                                  PATH_KERNELS["berson_mm_eval"],
                                  len(mm_test), 0)):
        raise AssertionError(f"BERSON launcher eval check failed: {summary}")
    return launches


def _berson_breakdown(model, seed, label, train_lens, eval_lens,
                      images=False):
    """One warm train step (stories of `train_lens` steps) and one warm
    eval batch (`eval_lens`, beam 16) of a trained full-width BERSON by
    kernel class (torch.profiler; convolutions apart with `images`), with
    the eval batch's encode and beam loop timed apart by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import (
        berson_train_step, device_batch)
    classes = ((CONV_CLASS,) if images else ()) + KERNEL_CLASSES
    opt = AdamW(model, learning_rate=1e-5, warmup_steps=2, total_steps=100)
    batch = _berson_batch(seed, train_lens, images)
    step = [0]

    def one():
        out = berson_train_step(model, opt, batch, step[0], seed)
        step[0] += 1
        return out

    step_ms = cuda_ms(one, iters=3, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    emit({"phase": "berson_path", "part": f"{label}_train_breakdown",
          "stories": len(train_lens), "step_ms": step_ms,
          **_by_class(prof, step_ms, classes)})
    del opt
    model.eval()
    db = device_batch(_berson_batch(seed + 1, eval_lens, images), "cuda")
    with torch.inference_mode():
        enc = model.encode(db)
        model.beam_search(db, enc)
        encode_ms = cuda_ms(lambda: model.encode(db), iters=3)
        beam_ms = cuda_ms(lambda: model.beam_search(db, enc), iters=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.beam_search(db, model.encode(db))
            torch.cuda.synchronize()
    emit({"phase": "berson_path", "part": f"{label}_eval_breakdown",
          "stories": len(eval_lens), "beam": 16, "encode_ms": encode_ms,
          "beam_loop_ms": beam_ms,
          **_by_class(prof, encode_ms + beam_ms, classes)})


# ----- pretraining -----------------------------------------------------------


PRETRAIN_OBJECTIVES = (
    "image_swapping", "image_sequence_predictions",
    "whole_image_sequence_swapping", "multimodal_swapping", "margin_loss",
    "multimodal_margin_loss", "time_contrastive",
    "patch_based_image_swapping", "patch_based_image_sequence_predictions",
    "patch_based_mrm_classification", "swapping_based_nsp",
    "sequence_based_nsp", "mlm_only")
LAUNCHER_OBJECTIVES = ("image_swapping", "patch_based_image_swapping",
                       "patch_based_mrm_classification")
TEXT_OBJECTIVES = ("margin_loss", "time_contrastive", "swapping_based_nsp",
                   "sequence_based_nsp")


def _pretrain_model(seed, objectives, **enc):
    """The CLIP-RN50 pretrainer at full width with 2 layers, f32
    (RoBERTa-large over the joint stream, the RN50 tower at 224 px, frozen)
    with the heads of `objectives`, the built-in tokenizer's ids, fresh
    weights from `seed`."""
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer as Tok)
    from multimodal_sequencing_tpu_torch.models.config import (
        CLIPVisionConfig, EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.pretrainer import (
        SequencingPretrainer)
    from multimodal_sequencing_tpu_torch.models.sequencer import init_weights
    cfg = MultimodalConfig(
        encoder=EncoderConfig.roberta_large(num_hidden_layers=2,
                                            dtype="float32", **enc),
        max_seq_length=300, per_seq_max_length=60, multimodal=True,
        clip_model_name="RN50", image_size=(MM_IMAGE, MM_IMAGE),
        freeze_vision_model=True, cls_id=Tok.CLS_ID, pad_id=Tok.PAD_ID,
        mask_id=Tok.MASK_ID, multimodal_pretrain_objectives=list(objectives))
    vcfg = CLIPVisionConfig.rn50(dtype="float32")
    return cfg, init_weights(SequencingPretrainer(cfg, vcfg), seed)


def _pretrain_plan(cfg, objective, seed, b=2, modality=None):
    """A batch of `b` packed 5-step stories (steps of 10..60 random words)
    with their step images, masked (p = 0.1) and planned for `objective`
    from `default_rng(seed)`; for multimodal_margin_loss the first seed
    from `seed` on whose plan draws `modality`."""
    import numpy as np
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.train.mlm import mask_tokens_sentence
    from multimodal_sequencing_tpu_torch.train.objectives import plan_objective
    packer = StoryPacker(SimpleWordTokenizer(), 300, 60)
    while True:
        rng = np.random.default_rng(seed)
        rows = [packer.pack_story([" ".join(rng.choice(
            WORDS, size=int(rng.integers(10, 61)))) for _ in range(5)])
            for _ in range(b)]
        batch = {k: np.stack([r[i] for r in rows]) for i, k in enumerate(
            ("input_ids", "attention_mask", "token_type_ids"))}
        batch["images"] = _random_images(b, seed + 1)
        batch["input_ids"], batch["mlm_labels"] = mask_tokens_sentence(
            batch["input_ids"], mlm_probability=0.1, pad_id=cfg.pad_id,
            cls_id=cfg.cls_id, mask_id=cfg.mask_id,
            vocab_size=cfg.encoder.vocab_size,
            ignore_index=cfg.mlm_ignore_index, rng=rng)
        nb, aux = plan_objective(objective, batch, cfg, rng)
        if modality is None or aux.get("modality") == modality:
            return nb, {k: v for k, v in aux.items()
                        if isinstance(v, np.ndarray) and v.ndim > 0}
        seed += 1


def _pretrain_cases():
    for obj in PRETRAIN_OBJECTIVES:
        if obj == "multimodal_margin_loss":
            for modality in ("multimodal", "text_only", "image_only"):
                yield obj, modality
        else:
            yield obj, None


# pretrain_reference, card (f32, kernels) against the CPU (plain versions)
# on the same weights and plans, the tower frozen (its train-mode f32
# gradients are ill-conditioned, mm_check), BatchNorm in train mode: each
# loss term within its own limit (`_term_limit`: "mlm_rel" for the MLM
# term, "loss_rel" for an objective's or margin's term, and the total
# within the larger of its terms'), each gradient's distance over the CPU's
# global norm within "grad_rel_to_norm", each statistic within
# "bn_stats_rel" of its largest entry. The steps: along the CPU's
# trajectory (the card takes its weights, statistics and Adam moments
# before each step): loss terms as above, grad norm, gradients, statistics,
# the card's update against the CPU's AdamW applied to the card's gradients
# within lr * 1e-3, its weights within lr of the CPU's. The objective terms
# read the pooled or step CLS outputs of a joint stream built on the frozen
# tower's train-mode f32 output (~1e-4 apart, mm_check), and the image_only
# margin's gradient rests on it alone (one CLS token of language, no MLM
# term): over seeds 0-3 (an H100, PERF.md) the objective terms read up to
# 4.71e-5 (time_contrastive, seed 1), the MLM terms up to 1.94e-6 (seed
# 3), the gradients up to 1.184e-4 of the norm (the image_only margin; the
# others 4.2e-5), statistics 1.18e-5; each limit is ~2.5x its readings, as
# the joint sequencer's and BERSON's are (the first objective limit,
# berson_reference's 3e-5, failed seeds 1 and 2).
PRETRAIN_TOL = {"loss_rel": 1.2e-4, "mlm_rel": 5e-6, "grad_norm_rel": 2e-4,
                "grad_rel_to_norm": 3e-4, "bn_stats_rel": 3e-5}
PRETRAIN_REF_STEPS = 3
# the dtype of each loss term in a bf16 model, as Flax promotes: the
# objective heads, the MRM head and the MLM decoder are f32 over bf16
# activations; time_contrastive's distances stay bf16
PRETRAIN_LOSS_DTYPES = {"time_contrastive": "bfloat16"}


def _term_limit(term, terms):
    """The relative limit of loss term `term` of a loss dict with `terms`
    (`PRETRAIN_TOL`); the total `loss` takes its largest term's."""
    if term == "loss":
        return max((_term_limit(t, ()) for t in terms if t != "loss"),
                   default=PRETRAIN_TOL["mlm_rel"])
    return PRETRAIN_TOL["mlm_rel" if term == "mlm" else "loss_rel"]


def _terms_ok(rel_errs):
    return all(v <= _term_limit(k, rel_errs) for k, v in rel_errs.items())


def _pretrain_run(model, nb, aux, objective, dev, seed):
    """One train-mode forward and backward of `objective`: the loss dict,
    the gradients (f64 on the CPU) and the BatchNorm statistics after."""
    import torch
    from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
    from multimodal_sequencing_tpu_torch.train.steps import device_batch
    model.train()
    model.zero_grad(set_to_none=True)
    losses = model(device_batch(nb, dev), objective, device_batch(aux, dev),
                   deterministic=False, rng=DropoutRng(seed + 1, 0, dev))
    losses["loss"].backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    return ({k: v.item() for k, v in losses.items()}, grads,
            _bn_stats(model), {k: str(v.dtype).split(".")[-1]
                               for k, v in losses.items()})


def phase_pretrain_reference(seed: int):
    """The full-width CLIP-RN50 pretrainer with 2 layers, f32, dropout 0,
    the tower frozen: card (kernels) against the CPU (plain versions) on
    the same weights and plans, for every objective (multimodal_margin_loss
    in each modality) on 2 stories: the loss dict, every gradient and the
    BatchNorm statistics; then the launcher's objectives for a few steps
    along the CPU's trajectory; and a bf16 pass on the card that reports
    each loss term's dtype against the JAX package's promotion."""
    import copy
    import dataclasses
    import torch
    from multimodal_sequencing_tpu_torch.models.pretrainer import (
        SequencingPretrainer)
    from multimodal_sequencing_tpu_torch.train.objectives import (
        choose_objective)
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    from multimodal_sequencing_tpu_torch.train.steps import pretrain_step
    import numpy as np
    torch.backends.cudnn.deterministic = True
    try:
        cfg, cpu_model = _pretrain_model(
            seed, PRETRAIN_OBJECTIVES, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
        init = copy.deepcopy(cpu_model.state_dict())
        card_model = copy.deepcopy(cpu_model).cuda()
        rel = lambda a, c: abs(a - c) / max(abs(c), 1e-12)  # noqa: E731
        rows, ok = [], True
        for objective, modality in _pretrain_cases():
            nb, aux = _pretrain_plan(cfg, objective, seed, modality=modality)
            out = {}
            for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
                model.load_state_dict(init)
                out[dev] = _pretrain_run(model, nb, aux, objective, dev, seed)
            (cl, cg, cs, _), (gl, gg, gs, _) = out["cpu"], out["cuda"]
            total = math.sqrt(sum(g.norm().item() ** 2 for g in cg.values()))
            row = {"objective": objective, "modality": modality,
                   "rows": int(nb["input_ids"].shape[0]),
                   "text_len": int(nb["input_ids"].shape[1]),
                   "images": (None if "images" not in nb
                              else int(nb["images"].shape[1])),
                   "losses_cpu": cl,
                   "loss_rel_err": {k: rel(gl[k], v) for k, v in cl.items()},
                   "grad_rel_to_norm": max(
                       (gg[n] - g).norm().item() / total
                       for n, g in cg.items()),
                   "same_grads": set(cg) == set(gg),
                   "tower_grads": sum(".visual_model." in n for n in gg),
                   "bn_stats_rel": max(_rel_to_max(gs[n], w)
                                       for n, w in cs.items())}
            row["ok"] = (set(cl) == set(gl) and row["same_grads"]
                         and not row["tower_grads"]
                         and all(math.isfinite(v) for v in gl.values())
                         and _terms_ok(row["loss_rel_err"])
                         and row["grad_rel_to_norm"]
                         <= PRETRAIN_TOL["grad_rel_to_norm"]
                         and row["bn_stats_rel"]
                         <= PRETRAIN_TOL["bn_stats_rel"])
            ok = ok and row["ok"]
            rows.append(row)
        emit({"phase": "pretrain_reference", "part": "objectives",
              "layers": 2, "dtype": "float32", "stories": 2,
              "tol": PRETRAIN_TOL, "cases": rows, "ok": ok})

        # the launcher's objectives, steps along the CPU's trajectory
        lr = 1e-3
        replay = copy.deepcopy(cpu_model)
        models = {"cpu": cpu_model, "cuda": card_model, "replay": replay}
        for model in models.values():
            model.load_state_dict(init)
        opts = {name: AdamW(model, learning_rate=lr, warmup_steps=1,
                            total_steps=10, weight_decay=0.01)
                for name, model in models.items()}
        host_rng = np.random.default_rng(seed)
        card_params = dict(card_model.named_parameters())
        steps = []
        for i in range(PRETRAIN_REF_STEPS):
            objective = choose_objective(LAUNCHER_OBJECTIVES, host_rng)
            nb, aux = _pretrain_plan(cfg, objective, seed + 10 + i)
            for name in ("cuda", "replay"):
                models[name].load_state_dict(cpu_model.state_dict())
                opts[name].load_state_dict(opts["cpu"].state_dict())
            hist, grads = {}, {}
            for name in ("cpu", "cuda"):
                hist[name] = {k: float(v) for k, v in pretrain_step(
                    models[name], opts[name], nb, aux, objective, i,
                    seed).items()}
                grads[name] = {n: p.grad.detach().double().cpu()
                               for n, p in models[name].named_parameters()
                               if p.grad is not None}
            for n, p in replay.named_parameters():
                p.grad = (grads["cuda"][n].float() if n in grads["cuda"]
                          else None)
            opts["replay"].step(opts["replay"].grads())
            total = math.sqrt(sum(g.norm().item() ** 2
                                  for g in grads["cpu"].values()))
            want, got = _bn_stats(cpu_model), _bn_stats(card_model)
            step = {"step": i, "objective": objective,
                    "loss": hist,
                    "loss_rel_err": {k: rel(hist["cuda"][k], v)
                                     for k, v in hist["cpu"].items()
                                     if k != "grad_norm"},
                    "grad_norm_rel_err": rel(hist["cuda"]["grad_norm"],
                                             hist["cpu"]["grad_norm"]),
                    "grad_rel_to_norm": max(
                        (grads["cuda"][n] - g).norm().item() / total
                        for n, g in grads["cpu"].items()),
                    "bn_stats_rel": max(_rel_to_max(got[n], w)
                                        for n, w in want.items()),
                    "max_abs_update_err": max(
                        (card_params[n].detach().cpu() - p.detach())
                        .abs().max().item()
                        for n, p in replay.named_parameters()),
                    "max_abs_weight_err": max(
                        (card_params[n].detach().cpu() - p.detach())
                        .abs().max().item()
                        for n, p in cpu_model.named_parameters())}
            step["ok"] = (_terms_ok(step["loss_rel_err"])
                          and step["grad_norm_rel_err"]
                          <= PRETRAIN_TOL["grad_norm_rel"]
                          and step["grad_rel_to_norm"]
                          <= PRETRAIN_TOL["grad_rel_to_norm"]
                          and step["bn_stats_rel"]
                          <= PRETRAIN_TOL["bn_stats_rel"]
                          and step["max_abs_update_err"] <= 1e-3 * lr
                          and step["max_abs_weight_err"] <= lr)
            ok = ok and step["ok"]
            steps.append(step)
        moved = max((p.detach() - init[n]).abs().max().item()
                    for n, p in cpu_model.named_parameters())
        emit({"phase": "pretrain_reference", "part": "steps", "lr": lr,
              "steps": steps, "max_abs_weight_move": moved,
              "ok": all(s_["ok"] for s_ in steps) and moved > 0})
        ok = ok and moved > 0
        del replay, opts, models

        # bf16 on the card: each loss term's dtype
        bf16 = SequencingPretrainer(
            dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, dtype="bfloat16")),
            dataclasses.replace(card_model.vision_cfg, dtype="bfloat16")
        ).cuda()
        bf16.load_state_dict(init)
        dtypes, finite = {}, True
        for objective, modality in _pretrain_cases():
            nb, aux = _pretrain_plan(cfg, objective, seed, modality=modality)
            losses, _, _, kinds = _pretrain_run(bf16, nb, aux, objective,
                                                "cuda", seed)
            case = f"{objective}@{modality}" if modality else objective
            dtypes[case] = kinds
            finite = finite and all(math.isfinite(v) for v in losses.values())
        want = {case: {k: PRETRAIN_LOSS_DTYPES.get(k, "float32") for k in d}
                for case, d in dtypes.items()}
        emit({"phase": "pretrain_reference", "part": "bf16_loss_dtypes",
              "dtypes": dtypes, "as_jax": dtypes == want, "finite": finite})
        ok = ok and dtypes == want and finite
    finally:
        torch.backends.cudnn.deterministic = False
    if not ok:
        raise AssertionError("card and CPU disagree on the pretrainer")


def _pretrain_argv(data_dir, out_dir, seed, kind, *extra):
    """The flags of `scripts/wikihow_pretrain.sh` (`kind` "launcher"), the
    same without the images and with the text objectives ("text"), or of
    `scripts/wikihow_image_only_pretrain.sh` ("img"), each with the
    built-in tokenizer at the launcher's widths (`--model_size large` /
    `base`), this run's data (splits train and test), logging every step,
    and `extra` (the step counts)."""
    argv = ["--model_name_or_path", "simple", "--tokenizer_name", "simple",
            "--do_train", "--do_eval", "--evaluate_during_training",
            "--per_gpu_train_batch_size", "4",
            "--per_gpu_eval_batch_size", "1", "--learning_rate", "1e-5",
            "--data_dirs", data_dir, "--data_names", "wikihow",
            "--max_story_length", "5", "--output_dir", out_dir,
            "--task_type", "pretrain", "--order_criteria", "loose",
            "--overwrite_output_dir", "--logging_steps", "1",
            "--max_eval_steps", "200", "--iters_to_eval", "20000",
            "--warmup_steps", "1000", "--eval_splits", "test",
            "--train_split", "train", "--seed", str(seed),
            "--device", "cuda"]
    if kind == "img":
        argv += ["--config_name", "bert-base-uncased", "--model_size", "base",
                 "--num_train_epochs", "4.0", "--max_seq_length", "50",
                 "--per_seq_max_length", "10", "--multimodal",
                 "--multimodal_img_part", "--multimodal_model_type", "clip",
                 "--vision_model", "resnet50",
                 "--multimodal_pretrain_objectives",
                 "patch_based_mrm_classification"]
    else:
        argv += ["--config_name", "roberta-large", "--model_size", "large",
                 "--num_train_epochs", "8.0", "--max_seq_length", "300",
                 "--per_seq_max_length", "60", "--mlm_probability", "0.1",
                 "--multimodal_pretrain_objectives",
                 *(LAUNCHER_OBJECTIVES if kind == "launcher"
                   else TEXT_OBJECTIVES)]
        if kind == "launcher":
            argv += ["--multimodal", "--multimodal_model_type", "clip",
                     "--vision_model", "resnet50"]
    return argv + list(extra)


def _pretrain_per_forward(layers, images, mlm, mrm):
    """Kernel launches of one pretraining forward (and, for the backward
    kernels, a step): the encoder's layers and, with images, the tower's
    attention pool; the LayerNorms of the layers and the embeddings,
    `visn_ln` with images, the MLM head's and the MRM head's (f32)."""
    return per_forward(layers, extra_ln=images + mlm + mrm, extra_attn=images)


def _pretrain_expected(drawn, evals, layers, images, mlm):
    """Exact launches of a run: (its train steps', a step for each
    objective drawn; its `evals` eval forwards', `mlm_only`, forward
    kernels only)."""
    train = dict.fromkeys(PATH_KERNELS["train"], 0)
    for objective in drawn:
        per = _pretrain_per_forward(
            layers, images, mlm, objective == "patch_based_mrm_classification")
        for k in train:
            train[k] += per[k]
    per = _pretrain_per_forward(layers, images, mlm, False)
    return train, {k: evals * per[k] if k in PATH_KERNELS["eval"] else 0
                   for k in PATH_KERNELS["train"]}


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


@contextlib.contextmanager
def _saves_not_written(calls: list):
    """Inside it, the train loops record each checkpoint save in `calls` as
    (absolute output_dir, step, name) and write nothing: for the runs whose
    checkpoints no check reads. The card machine takes 45 GiB of disk
    writes over the whole script, and a RoBERTa-large checkpoint with its
    optimizer's moments is ~3.6 GB; the runs whose saves are read drive
    the save itself."""
    from multimodal_sequencing_tpu_torch.train import loop
    save = loop.save_checkpoint

    def recorded(output_dir, step, *a, name=None, **kw):
        calls.append((os.path.abspath(output_dir), step, name))
        return os.path.join(calls[-1][0],
                            f"checkpoint-{step if name is None else name}")

    loop.save_checkpoint = recorded
    try:
        yield calls
    finally:
        loop.save_checkpoint = save


class _EvalCounts:
    """Launch counts of a run's evals apart from its train steps': `wrap`
    an eval function so the counts are reset to 0 just before each call
    and read just after, the train steps' held aside."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.held, self.evals = {}, {}

    def wrap(self, fn):
        def counted(*a, **kw):
            _add_counts(self.held, _read_counts())
            _reset_counts()
            out = fn(*a, **kw)
            _add_counts(self.evals, _read_counts())
            _reset_counts()
            return out
        return counted

    def split(self):
        """(the train steps' counts, the evals' counts) of the run."""
        return _add_counts(dict(self.held), _read_counts()), dict(self.evals)


def _pretrain_breakdown(res, argv, label, seed):
    """One warm train step of each of the run's objectives on a batch of
    its data, by kernel class (torch.profiler; convolutions apart)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_sequencing_tpu_torch.data.datasets import (
        PretrainDataset, data_loader)
    from multimodal_sequencing_tpu_torch.models.pretrainer import (
        resolve_objectives)
    from multimodal_sequencing_tpu_torch.train import cli
    from multimodal_sequencing_tpu_torch.train.loop import (PRETRAIN_KEYS,
                                                           mask_batch)
    from multimodal_sequencing_tpu_torch.train.objectives import plan_objective
    from multimodal_sequencing_tpu_torch.train.steps import pretrain_step
    args = cli.parse_args("pretrain", argv)
    cfg, tokenizer = cli.build_config(args)
    args.data_dir = args.data_dirs[0]
    ds = PretrainDataset(cli.load_examples(args, "wikihow", "pretrain",
                                           "train"), tokenizer,
                         **cli.dataset_kwargs(args))
    sample = next(data_loader(ds, args.per_gpu_train_batch_size))
    objectives, use_mlm = resolve_objectives(
        cfg.multimodal_pretrain_objectives)
    rng = np.random.default_rng(seed)
    step = [10_000]
    for objective in objectives:
        nb = {k: sample[k] for k in PRETRAIN_KEYS if k in sample}
        nb["input_ids"], nb["mlm_labels"] = mask_batch(cfg, args, nb, rng)
        nb, aux = plan_objective(objective, nb, cfg, rng)
        aux = {k: v for k, v in aux.items()
               if isinstance(v, np.ndarray) and v.ndim > 0}

        def one():
            out = pretrain_step(res.model, res.optimizer, nb, aux, objective,
                                step[0], seed, use_mlm)
            step[0] += 1
            return out

        step_ms = cuda_ms(one, iters=3, warmup=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
        emit({"phase": "pretrain_path", "part": f"{label}_breakdown",
              "objective": objective,
              "rows": int(nb["input_ids"].shape[0]),
              "text_len": int(nb["input_ids"].shape[1]),
              "images": (None if "images" not in nb
                         else int(nb["images"].shape[1])),
              "step_ms": step_ms,
              **_by_class(prof, step_ms, (CONV_CLASS,) + KERNEL_CLASSES)})


def phase_pretrain_path(seed: int, work: str):
    """Pretraining through `trainers.run_pretraining`'s `main_pretrain` at
    the launchers' settings on synthetic WikiHow stories with PNG step
    images: `scripts/wikihow_pretrain.sh` (RoBERTa-large, CLIP-RN50 at 224
    px, batch 4, S 300 / 60, MLM p = 0.1, lr 1e-5, its three objectives) for
    8 steps with a save and dev eval at step 8, then `--do_eval`; the same
    text-only with `margin_loss time_contrastive swapping_based_nsp
    sequence_based_nsp`, 8 steps, then `--do_eval`;
    `scripts/wikihow_image_only_pretrain.sh` (bert-base widths, S 50 / 10,
    `--multimodal_img_part`, patch MRM) for 4 steps, then `--do_eval`, whose
    final checkpoint's tower a fine-tune run (`main_train --multimodal
    --clip_visual_model_weights`) then loads bit for bit. Each run: exact
    launch counts of its train steps, from the objectives it drew, and of
    its dev evals apart (`{label}_eval`), the median step, peak memory, the
    dev eval, and a profiled step of each objective by kernel class."""
    import torch
    from multimodal_sequencing_tpu_torch.train import loop
    from multimodal_sequencing_tpu_torch.train.cli import (main_pretrain,
                                                           main_train)
    data_dir = os.path.join(work, "pretrain_data")
    os.makedirs(data_dir)
    write_wikihow(data_dir, "train", 4 * PRETRAIN_STEPS, seed + 11,
                  images=True)
    write_wikihow(data_dir, "test", PRETRAIN_DEV_STORIES, seed + 12,
                  images=True)
    drawn, counts = [], _EvalCounts()
    choose, evaluate = loop.choose_objective, loop.evaluate_pretraining

    def recorded(objectives, rng):
        drawn.append(choose(objectives, rng))
        return drawn[-1]

    # label, kind, steps, save_steps (0: the final save alone, no dev eval
    # during training), layers, images, MLM, whether its saves are written.
    # One save a run, the launcher's at its last step with a dev eval; the
    # text run's save is recorded and not written (`_saves_not_written`):
    # no check reads it
    runs = (
        ("pretrain_train", "launcher", PRETRAIN_STEPS, PRETRAIN_STEPS,
         NUM_LAYERS, 1, 1, True),
        ("pretrain_text", "text", PRETRAIN_STEPS, 0, NUM_LAYERS, 0, 1, False),
        ("pretrain_img", "img", PRETRAIN_IMG_STEPS, 0, 12, 1, 0, True))
    launches = {}
    loop.choose_objective = recorded
    loop.evaluate_pretraining = counts.wrap(evaluate)
    try:
        for label, kind, steps, save, layers, images, mlm, written in runs:
            out_dir = os.path.join(work, label)
            argv = _pretrain_argv(data_dir, out_dir, seed, kind,
                                  "--max_steps", str(steps),
                                  "--save_steps", str(save))
            if not save:
                argv.remove("--evaluate_during_training")
            drawn.clear()
            counts.reset()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            with (contextlib.nullcontext([]) if written
                  else _saves_not_written([])) as unwritten:
                res = main_pretrain(argv)
            wall_s = time.perf_counter() - t0
            # the train steps' launches and the dev evals' apart
            launches[label], launches[f"{label}_eval"] = train, dev = \
                counts.split()
            # dev evals at each save and --do_eval, a forward a story
            saves = list(range(save, steps + 1, save)) if save else []
            evals = (len(saves) + 1) * PRETRAIN_DEV_STORIES
            want, want_dev = _pretrain_expected(drawn, evals, layers, images,
                                                mlm)
            step_s = _berson_steps(res)
            losses = [h["loss"] for h in res.history]
            with open(os.path.join(out_dir, "logs", "scalars.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            evals_at = {r["step"]: r["value"] for r in rows
                        if r["tag"] == ("pretrain/eval_perplexity" if mlm
                                        else "pretrain/eval_loss")}
            summary = {"phase": "pretrain_path", "part": label,
                       "steps": res.global_step, "objectives": list(drawn),
                       "stories_a_step": 4, "launches": train,
                       "launches_predicted": want, "eval_forwards": evals,
                       "eval_launches": dev,
                       "eval_launches_predicted": want_dev,
                       "losses": losses,
                       "loss_terms": [{k: v for k, v in h.items()
                                       if k not in ("step", "time")}
                                      for h in res.history],
                       "step_s": step_s,
                       "median_step_s_after_first": _median_after_first(
                           step_s),
                       "peak_memory_gib":
                           torch.cuda.max_memory_allocated() / 2**30,
                       "eval_during_training": evals_at,
                       "eval_results": res.eval_results,
                       "saves_not_written": unwritten,
                       "wall_s_incl_init": wall_s}
            emit(summary)
            ok = (res.global_step == steps and len(drawn) == steps
                  and (written or unwritten == [(os.path.abspath(out_dir), steps,
                                                None)])
                  and all(math.isfinite(x) for x in losses)
                  and all(train[k] == want[k] for k in want)
                  and all(dev.get(k, 0) == want_dev[k] for k in want_dev)
                  and all(train[k] == dev.get(k, 0) == 0 for k in F32_BWD)
                  and sorted(evals_at) == saves
                  and os.path.isfile(os.path.join(
                      out_dir, "eval_results_pretrain.txt"))
                  and all(math.isfinite(v) for v in res.eval_results.values())
                  and (not mlm or res.eval_results.get(
                      "eval_perplexity", 0) > 1))
            if not ok:
                raise AssertionError(f"pretraining check failed: {summary}")
            _pretrain_breakdown(res, argv, label, seed)
            ckpt = os.path.join(out_dir, f"checkpoint-{res.global_step}")
            del res
            torch.cuda.empty_cache()
    finally:
        loop.choose_objective, loop.evaluate_pretraining = choose, evaluate

    # the image-only checkpoint's tower into a fine-tune run (the joint
    # sequencer at bert-base widths, as the image-only launcher's): one
    # step at learning rate 0 (the warmup's first update) keeps its weights
    # (the tuned weights read in memory; its save is not written)
    ft_dir = os.path.join(work, "pretrain_finetune")
    _reset_counts()
    with _saves_not_written([]) as unwritten:
        res = main_train(_mm_train_argv(data_dir, ft_dir, seed) + [
            "--model_size", "base", "--max_steps", "1",
            "--per_gpu_train_batch_size", "4",
            "--clip_visual_model_weights", ckpt])
    launches["pretrain_finetune"] = ft = _read_counts()
    prefix = "encoder.visual_model."
    tower = {k: v for k, v in torch.load(
        os.path.join(ckpt, "model.pt"), map_location="cpu",
        weights_only=True).items() if k.startswith(prefix)}
    tuned = res.model.state_dict()
    weights = [k for k in tower if "running_" not in k]
    same = all(torch.equal(tuned[k].cpu(), tower[k]) for k in weights)
    summary = {"phase": "pretrain_path", "part": "visual_transfer",
               "tower_tensors": len(tower), "weights_bit_equal": same,
               "loss": res.history[0]["loss"], "launches": ft,
               "saves_not_written": unwritten}
    emit(summary)
    want = _pretrain_per_forward(12, 1, 0, 0)  # a step of the sequencer
    if not (weights and same and math.isfinite(res.history[0]["loss"])
            and unwritten == [(os.path.abspath(ft_dir), 1, None)]
            and all(ft[k] == want[k]
                    for k in PATH_KERNELS["pretrain_finetune"])):
        raise AssertionError(f"visual transfer check failed: {summary}")
    return launches


# ----- RecipeQA ----------------------------------------------------------------


def write_recipeqa(root: str, seed: int) -> dict:
    """A RecipeQA tree: `texts/{train,val,test}.json` of 5-step recipes
    whose steps fill `per_seq_max_length` = 60 tokens, each step with a
    256 x 192 PNG named `{recipe_id}_{step}_0.jpg` under
    `images/images-qa/<split>/images-qa/`; every test recipe carries
    `multiref_gt` (the last one, which is human-annotated, two references);
    then the port's `human_annotated_to_test` writes the `new_splits`
    versions the launchers name (train-human_annot, test-acl_human,
    test-human_annot_only, train-acl22, test-acl22_human). Returns the
    images by path."""
    import numpy as np
    from multimodal_sequencing_tpu_torch.data.recipeqa import (
        human_annotated_to_test)
    rng = np.random.default_rng(seed)
    written = {}
    os.makedirs(os.path.join(root, "texts"))
    for split, n in (("train", RQ_TRAIN), ("val", 2), ("test", RQ_TEST)):
        img_dir = os.path.join(root, "images", "images-qa", split, "images-qa")
        os.makedirs(img_dir)
        data = []
        for r in range(n):
            rid = f"{split}-recipe_{r}"
            context = []
            for s in range(5):
                words = rng.choice(WORDS, size=70).tolist()
                context.append({"id": s, "body": f"Recipe {r} step {s}. "
                                + " ".join(words)})
                blocks = rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)
                path = os.path.join(img_dir, f"{rid}_{s}_0.jpg")
                written[path] = np.kron(blocks, np.ones((32, 32, 1), np.uint8))
                write_png(path, written[path])
            record = {"recipe_id": rid, "context": context}
            if split == "test":
                record["multiref_gt"] = [[1, 2, 3, 4, 5]] + (
                    [[2, 1, 3, 4, 5]] if r == n - 1 else [])
            data.append(record)
        with open(os.path.join(root, "texts", f"{split}.json"), "w") as f:
            json.dump({"version": 0.9, "data": data}, f)
    human = os.path.join(root, "human.jsonl")
    with open(human, "w") as f:
        f.write(json.dumps({"guid": f"test-recipe_{RQ_TEST - 1}"}) + "\n")
    for version in ("human_annot", "acl_human", "acl22", "acl22_human"):
        human_annotated_to_test(root, [human],
                                out_dir=os.path.join(root, "new_splits"),
                                version=version)
    return written


def _recipeqa_argv(kind, data_dir, out_dir, seed, *extra):
    """The flags of `scripts/recipeqa_finetune.sh` ("finetune"),
    `recipeqa_pretrain.sh` ("pretrain") or
    `recipeqa_image_only_pretrain.sh` ("img"), their split versions
    included, with the built-in tokenizer at the launchers' bert-base
    widths (`--model_size base`), this run's data and output, logging
    every step, and `extra` (the step counts). Their save steps (2000) lie
    past the run's steps unless `extra` sets them."""
    common = ["--model_name_or_path", "simple", "--config_name",
              "bert-base-uncased", "--tokenizer_name", "simple",
              "--model_size", "base", "--do_train", "--do_eval",
              "--evaluate_during_training", "--per_gpu_eval_batch_size", "1",
              "--output_dir", out_dir, "--order_criteria", "loose",
              "--overwrite_output_dir", "--multimodal",
              "--multimodal_model_type", "clip", "--vision_model", "resnet50",
              "--save_steps", "2000", "--logging_steps", "1",
              "--seed", str(seed), "--device", "cuda"]
    if kind == "finetune":
        argv = ["--do_not_load_optimizer", "--per_gpu_train_batch_size", "1",
                "--learning_rate", "5e-6", "--num_train_epochs", "4.0",
                "--max_seq_length", "300", "--per_seq_max_length", "60",
                "--data_dir", data_dir, "--task_name", "recipeqa_hl_v1",
                "--wrapper_model_type", "berson",
                "--train_split", "train-human_annot",
                "--max_eval_steps", "1000", "--iters_to_eval", "16000",
                "--warmup_steps", "100", "--eval_splits", "test-acl_human"]
    else:
        argv = ["--per_gpu_train_batch_size", "4", "--num_train_epochs",
                "20.0", "--data_dirs", data_dir, "--data_names", "recipeqa",
                "--max_story_length", "5", "--task_type", "pretrain",
                "--max_eval_steps", "200", "--iters_to_eval", "20000"]
        if kind == "pretrain":
            argv += ["--learning_rate", "5e-6", "--max_seq_length", "300",
                     "--per_seq_max_length", "60", "--warmup_steps", "500",
                     "--eval_splits", "test-human_annot_only",
                     "--train_split", "train-human_annot",
                     "--mlm_probability", "0.1",
                     "--multimodal_pretrain_objectives", *LAUNCHER_OBJECTIVES]
        else:
            argv += ["--learning_rate", "1e-5", "--max_seq_length", "50",
                     "--per_seq_max_length", "10", "--multimodal_img_part",
                     "--warmup_steps", "1000", "--eval_splits",
                     "test-acl22_human", "--train_split", "train-acl22",
                     "--multimodal_pretrain_objectives",
                     "patch_based_mrm_classification"]
    return common + argv + list(extra)


def _trained_on_after(out_dir, save, last):
    """Whether a run that saved and evaluated at step `save` went back to
    training: its dev eval logged at `save` alone, and between
    `checkpoint-{save}` and `checkpoint-{last}` the optimizer counted each
    step and the RN50 tower's BatchNorm running statistics moved (a model
    left in eval mode would keep them)."""
    import torch

    def load(step, name):
        return torch.load(os.path.join(out_dir, f"checkpoint-{step}", name),
                          map_location="cpu", weights_only=True, mmap=True)

    with open(os.path.join(out_dir, "logs", "scalars.jsonl")) as f:
        eval_steps = sorted({r["step"] for r in map(json.loads, f)
                             if r["tag"].startswith("eval/")})
    counts = [load(s, "optimizer.pt")["optimizer"]["count"]
              for s in (save, last)]
    before, after = load(save, "model.pt"), load(last, "model.pt")
    stats = [k for k in before if "running_" in k]
    moved = sum(not torch.equal(before[k], after[k]) for k in stats)
    return {"eval_steps": eval_steps, "optimizer_counts": counts,
            "running_stats": len(stats), "running_stats_moved": moved,
            "ok": (eval_steps == [save] and counts[1] - counts[0] == last - save
                   and stats and moved == len(stats))}


def phase_recipeqa_path(seed: int, work: str):
    """The three RecipeQA launchers through the port's CLIs on a synthetic
    recipe tree (`write_recipeqa`), each with its own split versions, at
    bert-base widths with CLIP-RN50: `scripts/recipeqa_finetune.sh`
    (`main_train`, BERSON, batch 1) for 4 steps, a save at step 3 with the
    beam search over test-acl_human (`--evaluate_during_training`) and
    `checkpoint-best`, a fourth step after it (which must update the RN50
    BatchNorm statistics and the optimizer's count: the run went back to
    training), the final save, then its `--do_eval` beam search;
    `recipeqa_pretrain.sh` (`main_pretrain`, batch 4, S 300 / 60, its three
    objectives) and `recipeqa_image_only_pretrain.sh` (S 50 / 10, one text
    token, patch MRM) for 4 steps each, the final save (recorded, not
    written: `_saves_not_written`), then their `--do_eval` dev MLM
    evaluation. Each run: exact launch counts of its train steps and of its
    evals apart, finite losses, its saves, the median step and peak memory.
    Every step image fed is read back as written (a file that does not
    decode would be fed as zeros)."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data import images
    from multimodal_sequencing_tpu_torch.train import cli, loop
    data_dir = os.path.join(work, "recipeqa")
    written = write_recipeqa(data_dir, seed + 21)
    fed = {"calls": 0, "bad": []}
    read = images.read_image_rgb

    def checked_read(path):
        img = read(path)
        fed["calls"] += 1
        if not (img.any() and np.array_equal(img, written.get(path))):
            fed["bad"].append(path)
        return img

    drawn, counts = [], _EvalCounts()
    choose, evaluate = loop.choose_objective, loop.evaluate_pretraining
    berson_eval = cli._make_berson_eval_fn

    def recorded(objectives, rng):
        drawn.append(choose(objectives, rng))
        return drawn[-1]

    def counted_berson_eval(*a, **kw):
        fn = berson_eval(*a, **kw)
        return None if fn is None else counts.wrap(fn)

    runs = (("rq_finetune", "finetune", RQ_FT_STEPS),
            ("rq_pretrain", "pretrain", RQ_PRE_STEPS),
            ("rq_img", "img", RQ_PRE_STEPS))
    launches = {}
    images.read_image_rgb = checked_read
    loop.choose_objective = recorded
    loop.evaluate_pretraining = counts.wrap(evaluate)
    cli._make_berson_eval_fn = counted_berson_eval
    try:
        for label, kind, steps in runs:
            out_dir = os.path.join(work, label)
            # the finetune launcher saves at step 3, with the beam eval
            # during training and checkpoint-best, and trains on
            argv = _recipeqa_argv(kind, data_dir, out_dir, seed,
                                  "--max_steps", str(steps), "--save_steps",
                                  str(RQ_FT_SAVE if kind == "finetune"
                                      else 2000))
            drawn.clear()
            counts.reset()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            main = cli.main_train if kind == "finetune" else cli.main_pretrain
            with (contextlib.nullcontext([]) if kind == "finetune"
                  else _saves_not_written([])) as unwritten:
                res = main(argv)
            wall_s = time.perf_counter() - t0
            launches[label], launches[f"{label}_eval"] = train, evals = \
                counts.split()
            if kind == "finetune":
                # the beam evals of test-acl_human, at the save and after
                # training: one encode a recipe
                want = _expected(RQ_PER_FORWARD, steps, steps,
                                 PATH_KERNELS["train"])
                want_eval = _expected(RQ_PER_FORWARD, 2 * RQ_TEST, 0,
                                      PATH_KERNELS["train"])
                saves = [f"checkpoint-{RQ_FT_SAVE}", f"checkpoint-{steps}",
                         "checkpoint-best"]
                eval_results = res.eval_results.get(
                    f"checkpoint-{steps}", {}).get("test-acl_human", {})
                resumed = _trained_on_after(out_dir, RQ_FT_SAVE, steps)
            else:
                # the dev eval of the human-annotated recipe(s), a forward
                # a recipe at batch 1
                dev = 1 if kind == "pretrain" else RQ_TEST
                want, want_eval = _pretrain_expected(
                    drawn, dev, RQ_LAYERS, 1, int(kind == "pretrain"))
                eval_results = res.eval_results
                saves = []
                resumed = {"ok": unwritten == [(os.path.abspath(out_dir),
                                                steps, None)]}
            step_s = _berson_steps(res)
            losses = [h["loss"] for h in res.history]
            saved = sorted(n for n in os.listdir(out_dir)
                           if n.startswith("checkpoint-"))
            summary = {"phase": "recipeqa_path", "part": label,
                       "steps": res.global_step, "objectives": list(drawn),
                       "launches": train, "launches_predicted": want,
                       "eval_launches": evals,
                       "eval_launches_predicted": want_eval,
                       "losses": losses, "step_s": step_s,
                       "median_step_s_after_first": _median_after_first(
                           step_s),
                       "peak_memory_gib":
                           torch.cuda.max_memory_allocated() / 2**30,
                       "checkpoints": saved, "saves_not_written": unwritten,
                       "after_the_save": resumed,
                       "eval_results": eval_results,
                       "wall_s_incl_init": wall_s}
            emit(summary)
            ok = (res.global_step == steps and saved == saves
                  and resumed["ok"]
                  and all(math.isfinite(x) for x in losses)
                  and all(train.get(k, 0) == v for k, v in want.items())
                  and all(evals.get(k, 0) == v for k, v in want_eval.items())
                  and all(train.get(k, 0) == evals.get(k, 0) == 0
                          for k in F32_BWD)
                  and eval_results
                  and all(math.isfinite(v) for v in eval_results.values()))
            if not ok:
                raise AssertionError(f"RecipeQA launcher check failed: "
                                     f"{summary}")
            del res
            torch.cuda.empty_cache()
    finally:
        images.read_image_rgb = read
        loop.choose_objective, loop.evaluate_pretraining = choose, evaluate
        cli._make_berson_eval_fn = berson_eval
    summary = {"phase": "recipeqa_path", "part": "step_images",
               "written": len(written), "decoded": fed["calls"],
               "not_as_written": fed["bad"][:5]}
    emit(summary)
    if fed["bad"] or not fed["calls"]:
        raise AssertionError(f"RecipeQA step images: {summary}")
    return launches


# ----- the v0 baselines -----------------------------------------------------------


def _v0_train_argv(data_dir, out_dir, seed, task):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", f"wikihow_{task}", "--hierarchical_version", "v0",
            "--order_criteria", "loose", "--data_dir", data_dir,
            "--max_seq_length", "320", "--per_seq_max_length", "60",
            "--per_gpu_train_batch_size", "8", "--learning_rate", "1e-5",
            "--warmup_steps", "2", "--max_steps", str(V0_STEPS),
            "--logging_steps", "1", "--save_steps", "0", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda"]


def _v0_eval_argv(data_dir, out_dir, seed, method, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--task_name", "wikihow_sort",
            "--sort_method", method, "--data_dir", data_dir,
            "--eval_splits", "test", "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_eval_batch_size", "8",
            "--seed", str(seed), "--output_dir", out_dir, "--device", "cuda",
            *extra]


def _v0_forwards(method, stories):
    """The forwards of a baseline eval of `stories` 5-step stories in
    batches of 8 at micro-batch 32: 20 pairs a story, a whole-story
    forward for the head and pure_class models, 60 triples a story for the
    abductive cube."""
    batches = [min(8, stories - b) for b in range(0, stories, 8)]
    per = {"pairs": lambda n: -(-20 * n // 32), "story": lambda n: 1,
           "cube": lambda n: -(-60 * n // 32)}
    parts = {"topological": ("pairs",), "topological_device": ("pairs",),
             "head_and_topological": ("story", "pairs"),
             "head_and_sequential": ("story", "pairs"),
             "head_and_sequential_abductive": ("story", "pairs", "cube"),
             "pure_class": ("story",)}[method]
    return sum(per[p](n) for n in batches for p in parts)


def phase_baselines_path(seed: int, work: str):
    """The paper's v0 baselines through the port's CLIs at RoBERTa-large
    width on the card: `main_train --hierarchical_version v0` of
    wikihow_pairwise (loose pairs) and wikihow_head for 4 steps of 8, one
    save each; then `run_eval` of 16 test stories in batches of 8 with
    `topological` (host decode and `--device_decode`) on the pairwise
    checkpoint, `head_and_topological` and `head_and_sequential` on the
    head and pairwise checkpoints, `head_and_sequential_abductive` with a
    fresh abductive model (`--model_name_or_path_3`), and `pure_class` with
    a fresh 120-label model. Each: exact launch counts from its forwards
    (steps), orders that are permutations, the median batch after the
    first (forward and decode apart) and peak memory."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import main_train, run_eval
    data_dir = os.path.join(work, "v0_data")
    os.makedirs(data_dir)
    write_wikihow(data_dir, "train", 8, seed + 31)
    write_wikihow(data_dir, "test", 2 * V0_EVAL_STORIES, seed + 32)
    launches, ckpts = {}, {}
    per = {k: PER_FORWARD[k] for k in PATH_KERNELS["train"]}
    for task in ("pairwise", "head"):
        out_dir = os.path.join(work, f"v0_{task}")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = main_train(_v0_train_argv(data_dir, out_dir, seed, task))
        launches[f"v0_{task}"] = counts = _read_counts()
        want = _expected(per, V0_STEPS, V0_STEPS, PATH_KERNELS["train"])
        step_s = _berson_steps(res)
        losses = [h["loss"] for h in res.history]
        ckpts[task] = os.path.join(out_dir, f"checkpoint-{V0_STEPS}")
        summary = {"phase": "baselines_path", "part": f"train_{task}",
                   "steps": res.global_step, "rows_a_step": 8,
                   "launches": counts, "launches_predicted": want,
                   "losses": losses, "step_s": step_s,
                   "median_step_s_after_first": _median_after_first(step_s),
                   "peak_memory_gib":
                       torch.cuda.max_memory_allocated() / 2**30}
        emit(summary)
        if not (res.global_step == V0_STEPS
                and all(math.isfinite(x) for x in losses)
                and all(counts[k] == v for k, v in want.items())
                and all(counts[k] == 0 for k in F32_BWD)
                and os.path.isfile(os.path.join(ckpts[task], "model.pt"))):
            raise AssertionError(f"v0 train check failed: {summary}")
        del res
        torch.cuda.empty_cache()
    evals = {
        "topological": ["--model_name_or_path_1", ckpts["pairwise"]],
        "topological_device": ["--model_name_or_path_1", ckpts["pairwise"],
                               "--device_decode"],
        "head_and_topological": ["--model_name_or_path_1", ckpts["head"],
                                 "--model_name_or_path_2", ckpts["pairwise"]],
        "head_and_sequential": ["--model_name_or_path_1", ckpts["head"],
                                "--model_name_or_path_2", ckpts["pairwise"]],
        "head_and_sequential_abductive": [
            "--model_name_or_path_1", ckpts["head"],
            "--model_name_or_path_2", ckpts["pairwise"],
            "--model_name_or_path_3", "simple"],
        "pure_class": []}
    stories = 2 * V0_EVAL_STORIES
    per_eval = {k: PER_FORWARD[k]
                for k in PATH_KERNELS["eval"]}
    for name, flags in evals.items():
        method = name.replace("_device", "")
        ev_dir = os.path.join(work, f"v0_eval_{name}")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        results, evaluator = run_eval(_v0_eval_argv(
            data_dir, ev_dir, seed, method, *flags))
        launches[f"v0_{name}"] = counts = _read_counts()
        forwards = _v0_forwards(name, stories)
        want = _expected(per_eval, forwards, 0, PATH_KERNELS["eval"])
        fwd, dec = evaluator.forward_seconds, evaluator.decode_seconds
        summary = {"phase": "baselines_path", "part": f"eval_{name}",
                   "stories": stories, "batch": 8,
                   "forwards": evaluator.forwards,
                   "forwards_predicted": forwards, "launches": counts,
                   "launches_predicted": want,
                   "first_batch_s": fwd[0] + dec[0],
                   "median_batch_s": _median_after_first(
                       [f + d for f, d in zip(fwd, dec)]),
                   "median_forward_s": _median_after_first(fwd),
                   "median_decode_s": _median_after_first(dec),
                   "peak_memory_gib":
                       torch.cuda.max_memory_allocated() / 2**30,
                   "metrics": results["test"]}
        emit(summary)
        if not (evaluator.forwards == forwards
                and _check_eval_outputs(ev_dir, stories)
                and all(counts[k] == v for k, v in want.items())
                and all(counts[k] == 0 for k in PATH_KERNELS["train"]
                        if k not in PATH_KERNELS["eval"])):
            raise AssertionError(f"v0 eval check failed: {summary}")
    return launches


# per-term limits of the 2-layer v0 reference (card against CPU, f32):
# the logits relative to their largest entry, the loss relative, each
# parameter's gradient relative to the global gradient norm; ~2.5x the
# largest reading over seeds 0-3 (3.97e-6, 2.17e-7, 1.19e-6)
V0_REF_TOL = {"logits_rel": 1e-5, "loss_rel": 6e-7, "grad_rel_to_norm": 3e-6}


def phase_baselines_reference(seed: int):
    """The v0 sequencer at full RoBERTa-large width, 2 layers, f32, dropout
    0: card (kernels) against the CPU (plain versions) on the same weights
    and inputs, for the pairwise head (32 packed step pairs at S = 128)
    and the head model (8 stories at S = 320, 5 labels): the eval-mode
    logits, and the train-mode v0 loss and every parameter's gradient."""
    import copy
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.models.config import (
        EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    from multimodal_sequencing_tpu_torch.train.steps import compute_loss
    tok = SimpleWordTokenizer()
    packer = StoryPacker(tok, 320, 60)
    rng = np.random.default_rng(seed)
    stories = [[" ".join(rng.choice(WORDS, size=int(rng.integers(10, 70))))
                for _ in range(5)] for _ in range(8)]
    pairs = [packer.pack_all_pairs(t, V0_PAIR_LEN) for t in stories[:2]]
    pair_batch = [np.concatenate([p[i] for p in pairs])[:32]
                  for i in range(3)]
    packs = [packer.pack_story(t) for t in stories]
    story_batch = [np.stack([p[i] for p in packs]) for i in range(3)]
    readings, ok = {}, True
    for task, labels, batch in (("pairwise", 2, pair_batch),
                                ("head", 5, story_batch)):
        cfg = MultimodalConfig(
            encoder=EncoderConfig.roberta_large(
                type_vocab_size=5, vocab_size=len(tok), num_hidden_layers=2,
                dtype="float32", hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0),
            hierarchical_version="v0", num_labels=labels, max_seq_length=320)
        cpu = init_weights(SequencingModel(cfg), seed)
        card = copy.deepcopy(cpu).cuda()
        ids, am, tt = (torch.from_numpy(x).long() for x in batch)
        target = {"labels": torch.from_numpy(rng.integers(
            0, labels, ids.shape[0])).long(),
            "valid": torch.ones(ids.shape[0], dtype=torch.bool)}
        out = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
            inputs = [x.to(dev) for x in (ids, am, tt)]
            with torch.inference_mode():
                logits = model.eval()(*inputs)["logits"].cpu()
            model.train()
            res = model(*inputs, deterministic=False,
                        rng=DropoutRng(seed, 0, dev))
            loss = compute_loss(cfg, res, {k: v.to(dev) for k, v in
                                           target.items()})[0]
            loss.backward()
            out[name] = (logits, loss.item(), {
                n: p.grad.detach().double().cpu()
                for n, p in model.named_parameters() if p.grad is not None})
        (lw, sw, gw), (lg, sg, gg) = out["cpu"], out["cuda"]
        norm = math.sqrt(sum(g.norm().item() ** 2 for g in gw.values()))
        grad_rel = sorted((((gg[n] - g).norm().item() / norm, n)
                           for n, g in gw.items()), reverse=True)
        reading = {"logits_rel": ((lg - lw).abs().max()
                                  / lw.abs().max()).item(),
                   "loss_rel": abs(sg - sw) / abs(sw),
                   "grad_rel_to_norm": grad_rel[0][0]}
        readings[task] = {**reading, "rows": int(ids.shape[0]),
                          "seq": int(ids.shape[1]), "loss": sw,
                          "worst_grads": grad_rel[:3],
                          "grads_compared": len(gw)}
        ok = ok and set(gg) == set(gw) and all(
            reading[k] <= V0_REF_TOL[k] for k in V0_REF_TOL)
    emit({"phase": "baselines_reference", "layers": 2, "dtype": "float32",
          "seed": seed, "readings": readings, "tol": V0_REF_TOL, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the 2-layer v0 model")


# the ordering heads of the fine-tune CLI that are not heat maps: a
# 2-layer full-width reference of each (card against CPU, f32), then four
# RoBERTa-large runs through the CLIs
HEADS_STEPS = 4          # each run: steps of 8 stories
HEADS_EVAL_STORIES = 16  # each eval: 2 batches of 8 at micro-batch 32
HEADS_BEAMS, HEADS_DECODER_LN = 5, 3  # pure_decode: beam 5, 3 LayerNorms a
# decoder call (5 calls a generate: one a story step)
# the reference's models: (version, auxiliary objectives)
HEADS_REF_MODELS = (("p0", ("head", "binary", "itm", "mlm")),
                    ("p1", ("head", "pairwise", "mlm")),
                    ("decode", ()))
# below it a head's logit is one of its -1e9 masks
HEADS_MASKED = -1e8
# per-term limits of the 2-layer references (card against CPU, f32): the
# logits relative to their largest unmasked entry, each loss term
# relative, each parameter's gradient relative to the global gradient
# norm; ~2.5x the largest reading over seeds 0-3 (logits 3.11e-6, greedy
# 4.11e-6, head 2.36e-6, binary 3.04e-6, itm 2.32e-6, mlm 2.35e-6,
# decoder 1.02e-6; NLL 1.97e-7, aux terms 5.83e-7 / 5.46e-7 / 3.27e-7 /
# 2.14e-7, loss 3.06e-7; gradients 9.91e-7)
HEADS_REF_TOL = {"pointer_logits": 8e-6, "pointer_logits_greedy": 1e-5,
                 "head_logits": 6e-6, "bin_logits": 8e-6, "itm_logits": 6e-6,
                 "mlm_logits": 6e-6, "dec_logits": 2.5e-6,
                 "pointer_nll": 5e-7, "aux_head": 1.5e-6, "aux_binary": 1.4e-6,
                 "aux_itm": 8e-7, "aux_mlm": 5.5e-7, "loss": 8e-7,
                 "grad_rel_to_norm": 2.5e-6}


def _heads_ref_model(version, objectives, seed, vocab):
    from multimodal_sequencing_tpu_torch.models.config import (
        EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.pure_decode import (
        EncoderIndexDecoder)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    cfg = MultimodalConfig(
        encoder=EncoderConfig.roberta_large(
            type_vocab_size=5, vocab_size=vocab, num_hidden_layers=2,
            dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0),
        hierarchical_version=version, max_seq_length=320,
        hl_include_objectives=list(objectives))
    model = (EncoderIndexDecoder(cfg) if version == "decode"
             else SequencingModel(cfg))
    return cfg, init_weights(model, seed)


def _heads_ref_run(cfg, model, inputs, batch):
    """One device's readings: the outputs of a teacher-forced forward, its
    loss terms and gradients; the greedy pointer logits and their decode,
    or the generated tokens."""
    import torch
    from multimodal_sequencing_tpu_torch.models.heads import PointerHead
    from multimodal_sequencing_tpu_torch.train.steps import compute_loss
    model.eval()
    out = model(*inputs, order_labels=batch["labels"])
    loss, terms = compute_loss(cfg, out, batch)
    loss.backward()
    got = {k: out[k].detach().cpu() for k in (
        "pointer_logits", "head_logits", "bin_logits", "itm_logits",
        "mlm_logits", "dec_logits") if k in out}
    got.update({k: v.item() for k, v in terms.items()})
    with torch.no_grad():
        if cfg.hierarchical_version == "decode":
            got["tokens"] = model.generate(*inputs).cpu()
        else:
            got["pointer_nll"] = PointerHead.loss(
                out["pointer_logits"], batch["labels"],
                out["present"]).item()
            greedy = model(*inputs)
            got["pointer_logits_greedy"] = greedy["pointer_logits"].cpu()
            got["decode"] = PointerHead.decode(greedy["pointer_logits"],
                                               greedy["present"]).cpu()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    return got, grads


def phase_heads_reference(seed: int):
    """The p0 and p1 pointer sequencers with their auxiliary heads and the
    pure_decode encoder-decoder at full RoBERTa-large width, 2 layers, f32,
    dropout 0, deterministic (the aux heads' own dropout 0.5 off): card
    (kernels) against the CPU (plain versions) on the same weights and 4
    stories at S = 320 (masked for the MLM aux, with ITM targets): the
    teacher-forced pointer logits, the greedy ones and their decode, each
    aux head's logits, every loss term, every parameter's gradient; the
    decoder's logits, loss, token accuracy and gradients, and `generate`'s
    tokens, which must be equal."""
    import copy
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.train.mlm import (
        mask_tokens_sentence)
    tok = SimpleWordTokenizer()
    packer = StoryPacker(tok, 320, 60)
    rng = np.random.default_rng(seed)
    stories = [[" ".join(rng.choice(WORDS, size=int(rng.integers(10, 70))))
                for _ in range(5)] for _ in range(4)]
    packs = [packer.pack_story(t) for t in stories]
    ids, am, tt = (np.stack([p[i] for p in packs]) for i in range(3))
    readings, ok = {}, True
    for version, objectives in HEADS_REF_MODELS:
        cfg, cpu = _heads_ref_model(version, objectives, seed, len(tok))
        masked, mlm_labels = mask_tokens_sentence(
            ids, mlm_probability=0.15, pad_id=cfg.pad_id, cls_id=cfg.cls_id,
            mask_id=cfg.mask_id, vocab_size=len(tok), rng=rng)
        batch = {"labels": np.stack([rng.permutation(5) for _ in range(4)]),
                 "mlm_labels": mlm_labels,
                 "itm_targets": rng.integers(0, 2, 4),
                 "valid": np.ones(4, bool)}
        card = copy.deepcopy(cpu).cuda()
        runs = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", card, "cuda")):
            inputs = [torch.from_numpy(x).long().to(dev)
                      for x in (masked if "mlm" in objectives else ids, am,
                                tt)]
            db = {k: torch.from_numpy(v).to(dev, torch.bool if k == "valid"
                                            else torch.long)
                  for k, v in batch.items()}
            runs[name] = _heads_ref_run(cfg, model, inputs, db)
        (want, gw), (got, gg) = runs["cpu"], runs["cuda"]
        norm = math.sqrt(sum(g.norm().item() ** 2 for g in gw.values()))
        grad_rel = sorted((((gg[n] - g).norm().item() / norm, n)
                           for n, g in gw.items()), reverse=True)
        reading = {"grad_rel_to_norm": grad_rel[0][0]}
        for k, w in want.items():
            if k in ("tokens", "decode", "token_acc"):
                continue
            g = got[k]
            if not torch.is_tensor(w):
                reading[k] = abs(g - w) / abs(w)
                continue
            # the masked entries (-1e9: dead or already pointed steps)
            # must match; the others are read against their largest
            live = w > HEADS_MASKED
            reading[k] = (((g - w)[live].abs().max()
                           / w[live].abs().max()).item()
                          if torch.equal(live, g > HEADS_MASKED)
                          else math.inf)
        exact = {k: bool(torch.equal(got[k], want[k])) if torch.is_tensor(
            want[k]) else got[k] == want[k]
                 for k in ("tokens", "decode", "token_acc") if k in want}
        readings[version] = {**reading, "exact": exact,
                             "objectives": list(objectives),
                             "loss_value": want["loss"],
                             "worst_grads": grad_rel[:3],
                             "grads_compared": len(gw),
                             **({"tokens": want["tokens"].tolist()}
                                if "tokens" in want else {})}
        ok = ok and set(gg) == set(gw) and all(exact.values()) and all(
            v <= HEADS_REF_TOL[k] for k, v in reading.items())
        del card, cpu
        torch.cuda.empty_cache()
    emit({"phase": "heads_reference", "layers": 2, "dtype": "float32",
          "seed": seed, "rows": 4, "seq": 320, "readings": readings,
          "tol": HEADS_REF_TOL, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the 2-layer heads")


def _heads_argv(data_dir, out_dir, seed, task, version, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", f"wikihow_{task}", "--hierarchical_version",
            version, "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_train_batch_size", "8",
            "--learning_rate", "1e-5", "--warmup_steps", "2",
            "--max_steps", str(HEADS_STEPS), "--logging_steps", "1",
            "--save_steps", "0", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--eval_splits", "test", "--per_gpu_eval_batch_size", "8",
            "--device", "cuda", *extra]


# the four runs of `heads_path`: (label, task, version, flags, the extra
# LayerNorms of a train step, of an eval forward, the aux terms logged)
HEADS_RUNS = (
    ("heads_p0", "hl_v1", "p0",
     ("--hl_include_objectives", "head", "binary", "--do_eval",
      "--eval_save_all_results"), 2, 2, ("aux_head", "aux_binary")),
    ("heads_p1", "hl_v1", "p1",
     ("--hl_include_objectives", "head", "mlm", "--do_eval",
      "--eval_save_all_results"), 1, 0, ("aux_head", "aux_mlm")),
    ("heads_mm_itm", "hl_v1", "v1",
     ("--multimodal", "--multimodal_model_type", "clip",
      "--clip_model_name", "RN50", "--hl_include_objectives", "itm",
      "mlm_wo_loss"), 0, 0, ("aux_itm",)),
    ("heads_decode", "pure_decode", "v0", (), HEADS_DECODER_LN,
     5 * HEADS_DECODER_LN, ("token_acc",)))


def _itm_draws_ok(records, cfg, seed):
    """The loop's host surgery of each batch against the draws replayed
    from `default_rng(seed + 7)`: the MLM masking of the ids, then for
    each story a swap with p = 0.5 of one step image (drawn) for the next
    story's; the swapped rows' images moved, the others' did not, and
    `itm_targets` is 0 exactly on the swapped rows."""
    import numpy as np
    from multimodal_sequencing_tpu_torch.train.mlm import (
        mask_tokens_sentence)
    rng = np.random.default_rng(seed + 7)
    for before, after in records:
        ids, labels = mask_tokens_sentence(
            before["input_ids"], mlm_probability=cfg.mlm_probability,
            pad_id=cfg.pad_id, cls_id=cfg.cls_id, mask_id=cfg.mask_id,
            vocab_size=cfg.encoder.vocab_size,
            ignore_index=cfg.mlm_ignore_index, rng=rng)
        if not (np.array_equal(ids, after["input_ids"])
                and np.array_equal(labels, after["mlm_labels"])):
            return False
        imgs, b = before["images"], len(before["images"])
        want, targets = imgs.copy(), np.ones(b, np.int32)
        for i in range(b):
            if rng.random() > 0.5 and b > 1:
                s = int(rng.integers(imgs.shape[1]))
                want[i, s], targets[i] = imgs[(i + 1) % b, s], 0
        moved = (after["images"] != imgs).reshape(b, -1).any(-1)
        if not (np.array_equal(after["images"], want)
                and np.array_equal(after["itm_targets"], targets)
                and np.array_equal(moved, targets == 0)):
            return False
    return bool(records)


def phase_heads_path(seed: int, work: str):
    """The ordering heads of the fine-tune CLI that are not heat maps,
    through `main_train` and `run_eval` at RoBERTa-large (24 layers, bf16,
    dropout 0.1, the `simple` tokenizer) on synthetic WikiHow stories, 4
    steps of 8 each: p0 with the `head` and `binary` aux heads and p1 with
    `head` and `mlm` (`--do_eval`: the pointer substitution of
    `pure_decode` over 16 test stories, on the model in memory, its saves
    recorded and not written); the CLIP-RN50 v1 heat map with `itm` and
    `mlm_wo_loss` (S = 566, 5 PNG step images a story; the host surgery
    replayed: masks, swaps and targets); the pure_decode encoder-decoder,
    whose one save `run_eval --sort_method pure_decode` reads (16 stories
    at batch 8, beam 5). Each: exact launch counts of the train steps and
    of the eval apart, finite losses and aux terms, the median step, the
    eval's forward and decode times, peak memory and bytes written."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.train import cli, loop
    data_dir = os.path.join(work, "heads_data")
    mm_dir = os.path.join(work, "heads_mm_data")
    os.makedirs(data_dir)
    os.makedirs(mm_dir)
    write_wikihow(data_dir, "train", 8 * HEADS_STEPS, seed + 41)
    write_wikihow(data_dir, "test", HEADS_EVAL_STORIES, seed + 42)
    write_wikihow(mm_dir, "train", 8 * HEADS_STEPS, seed + 43, images=True)
    counts, evaluators, records = _EvalCounts(), [], []
    make_eval, make_evaluator = cli._make_dev_eval_fn, cli._evaluator
    surgery = loop.aux_surgery

    def counted_eval(*a, **kw):
        fn = make_eval(*a, **kw)
        return None if fn is None else counts.wrap(fn)

    def recorded_evaluator(*a, **kw):
        evaluators.append(make_evaluator(*a, **kw))
        return evaluators[-1]

    def recorded_surgery(cfg, s):
        prepare = surgery(cfg, s)
        if prepare is None:
            return None

        def recorded(batch):
            if "images" not in batch:
                return prepare(batch)
            before = {k: np.array(batch[k]) for k in ("input_ids", "images")}
            after = prepare(batch)
            records.append((before, {k: np.array(after[k]) for k in (
                "input_ids", "mlm_labels", "images", "itm_targets")}))
            return after
        return recorded

    launches = {}
    cli._make_dev_eval_fn, cli._evaluator = counted_eval, recorded_evaluator
    loop.aux_surgery = recorded_surgery
    try:
        for label, task, version, flags, train_ln, eval_ln, terms in \
                HEADS_RUNS:
            out_dir = os.path.join(work, label)
            mm = "--multimodal" in flags
            argv = _heads_argv(mm_dir if mm else data_dir, out_dir, seed,
                               task, version, *flags)
            counts.reset()
            evaluators.clear()
            records.clear()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            saves = []
            with (contextlib.nullcontext() if task == "pure_decode"
                  else _saves_not_written(saves)):
                res = cli.main_train(argv)
            train, evals = counts.split()
            per = (MM_PER_FORWARD if mm
                   else per_forward(NUM_LAYERS, extra_ln=train_ln))
            want = _expected(per, HEADS_STEPS, HEADS_STEPS,
                             PATH_KERNELS["train"])
            step_s = _berson_steps(res)
            history = res.history
            summary = {"phase": "heads_path", "part": label,
                       "steps": res.global_step, "rows_a_step": 8,
                       "launches": train, "launches_predicted": want,
                       "losses": [h["loss"] for h in history],
                       "aux_terms": {t: [h.get(t) for h in history]
                                     for t in terms},
                       "step_s": step_s,
                       "median_step_s_after_first":
                           _median_after_first(step_s),
                       "peak_memory_gib":
                           torch.cuda.max_memory_allocated() / 2**30,
                       "saves_recorded": saves,
                       "bytes_written_so_far": bytes_written()}
            ok = (res.global_step == HEADS_STEPS
                  and all(math.isfinite(h["loss"]) and all(
                      h.get(t) is not None and math.isfinite(h[t])
                      for t in terms) for h in history)
                  and all(train[k] == v for k, v in want.items())
                  and all(train[k] == 0 for k in F32_BWD))
            launches[label] = train
            if task == "pure_decode":
                ckpt = os.path.join(out_dir, f"checkpoint-{HEADS_STEPS}")
                with open(os.path.join(ckpt, "config.json")) as f:
                    saved = json.load(f)["hierarchical_version"]
                summary["saved_version"] = saved
                ok = ok and saved == "decode"
            else:
                ok = ok and saves == [(os.path.abspath(out_dir),
                                       HEADS_STEPS, None)]
            if mm:
                summary["itm_batches"] = len(records)
                summary["itm_targets"] = [r[1]["itm_targets"].tolist()
                                          for r in records]
                ok = ok and _itm_draws_ok(records, res.model.cfg, seed)
            if "--do_eval" in flags:
                ev = evaluators[0]
                launches[f"{label}_eval"] = evals
                summary.update(_heads_eval_summary(
                    ev, evals, eval_ln, res.eval_results, out_dir))
                ok = ok and summary.pop("eval_ok")
            emit(summary)
            if not ok:
                raise AssertionError(f"{label} check failed: {summary}")
            del res
            torch.cuda.empty_cache()
            if task == "pure_decode":
                launches.update(_heads_decode_eval(data_dir, work, seed,
                                                   ckpt))
    finally:
        cli._make_dev_eval_fn, cli._evaluator = make_eval, make_evaluator
        loop.aux_surgery = surgery
    return launches


def _heads_eval_summary(ev, counts, eval_ln, results, out_dir):
    """A `--do_eval` pointer substitution's readings and checks: 2
    forwards (16 stories at micro-batch 32), exact launches, orders that
    are permutations, one result, on the model in memory."""
    forwards = math.ceil(HEADS_EVAL_STORIES / 8)
    want = _expected(per_forward(NUM_LAYERS, extra_ln=eval_ln), forwards, 0,
                     PATH_KERNELS["eval"])
    fwd, dec = ev.forward_seconds, ev.decode_seconds
    perms = _check_eval_outputs(out_dir, HEADS_EVAL_STORIES)
    return {"eval_forwards": ev.forwards, "eval_launches": counts,
            "eval_launches_predicted": want, "eval_all_permutations": perms,
            "eval_median_batch_s": _median_after_first(
                [f + d for f, d in zip(fwd, dec)]),
            "eval_median_forward_s": _median_after_first(fwd),
            "eval_median_decode_s": _median_after_first(dec),
            "eval_metrics": results,
            "eval_ok": (ev.forwards == forwards and perms
                        and list(results) == [f"checkpoint-{HEADS_STEPS}"]
                        and all(counts[k] == v for k, v in want.items())
                        and all(counts[k] == 0 for k in PATH_KERNELS["train"]
                                if k not in PATH_KERNELS["eval"]))}


def _heads_decode_eval(data_dir, work, seed, ckpt):
    """`run_eval --sort_method pure_decode` of the pure_decode checkpoint
    over 16 test stories at batch 8 (micro-batch 32, beam 5): 2 encoder
    forwards and 10 decoder calls, exact launches, N tokens a story in the
    index vocabulary (a sequence need not be a permutation)."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import run_eval
    ev_dir = os.path.join(work, "heads_decode_eval")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    results, ev = run_eval(_eval_argv(data_dir, ev_dir, seed, "--sort_method",
                                      "pure_decode", model=ckpt))
    counts = _read_counts()
    forwards = math.ceil(HEADS_EVAL_STORIES / 8)
    want = _expected(per_forward(NUM_LAYERS, extra_ln=5 * HEADS_DECODER_LN),
                     forwards, 0, PATH_KERNELS["eval"])
    with open(os.path.join(ev_dir, "output_order.txt")) as f:
        tokens = [[int(x) for x in line.split()] for line in f]
    fwd, dec = ev.forward_seconds, ev.decode_seconds
    summary = {"phase": "heads_path", "part": "heads_decode_eval",
               "stories": HEADS_EVAL_STORIES, "batch": 8,
               "beams": HEADS_BEAMS, "forwards": ev.forwards,
               "launches": counts, "launches_predicted": want,
               "permutations": sum(sorted(t) == list(range(5))
                                   for t in tokens),
               "first_batch_s": fwd[0] + dec[0],
               "median_batch_s": _median_after_first(
                   [f + d for f, d in zip(fwd, dec)]),
               "median_encode_s": _median_after_first(fwd),
               "median_beam_s": _median_after_first(dec),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "metrics": results["test"],
               "bytes_written_so_far": bytes_written()}
    emit(summary)
    if not (ev.forwards == forwards and len(tokens) == HEADS_EVAL_STORIES
            and all(len(t) == 5 and 0 <= min(t) and max(t) < 7
                    for t in tokens)
            and math.isfinite(results["test"]["partial_match"])
            and all(counts[k] == v for k, v in want.items())):
        raise AssertionError(f"pure_decode eval check failed: {summary}")
    return {"heads_decode_eval": counts}


# ----- VisualBERT, the naive model and their towers (ROADMAP A5e) ------------

# per-reading limits of `visual_reference` (card against CPU, f32, 2
# layers at full width, resnet18 / R-18 FPN towers at 64 px): outputs
# relative to their largest entry, each loss term relative, each
# parameter's gradient over the global gradient norm, each BatchNorm
# statistic relative to its largest entry; ~2.5x the largest reading over
# seeds 0-3 (chip_smoke.py --phases visual_reference --seed N: outputs
# 7.11e-6, loss terms 4.92e-7, gradients 1.94e-6, statistics 1.49e-6)
VISUAL_REF_TOL = {"output": 1.8e-5, "loss": 1.25e-6,
                  "grad_rel_to_norm": 5e-6, "bn_stats": 4e-6}
VISUAL_REF_IMAGE = 64
VISUAL_REF_K = 3


def _visual_ref_cases():
    """(name, model kind, config changes): the VisualBERT sequencer with
    sidecars (as run (a)), the FPN sequencer on the sentinel (b), the naive
    sequencer (c), BERSON over VisualBERT (d) and the pretrainer over the
    inline-ROI FPN tower (e)."""
    k = VISUAL_REF_K
    return (("vb_sidecar", "seq", dict(multimodal_model_type="visualbert",
                                       vision_model="resnet18",
                                       num_img_regional_features=k)),
            ("vb_fpn_sentinel", "seq", dict(
                multimodal_model_type="visualbert",
                vision_model="detectron2_R_18_FPN",
                num_img_regional_features=k,
                include_full_img_features=False)),
            ("naive", "seq", dict(multimodal_model_type="naive",
                                  vision_model="resnet18")),
            ("vb_berson", "berson", dict(multimodal_model_type="visualbert",
                                         vision_model="resnet18",
                                         wrapper_model_type="berson")),
            ("vb_fpn_pretrain", "pretrain", dict(
                multimodal_model_type="visualbert",
                vision_model="detectron2_R_18_FPN",
                num_img_regional_features=k,
                include_full_img_features=False,
                multimodal_pretrain_objectives=["swapping_based_nsp"])))


def _visual_ref_inputs(kind, cfg, seed, b=4):
    """A batch of `b` packed 5-step stories (steps of 5..30 words) with
    their 64 px step images and, for the sidecar case, (b, 5, K, 2048)
    sidecars; BERSON's pair packing; the pretrainer's masked batch planned
    for swapping_based_nsp (and its aux)."""
    import numpy as np
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.train.mlm import mask_tokens_sentence
    from multimodal_sequencing_tpu_torch.train.objectives import plan_objective
    rng = np.random.default_rng(seed)
    packer = StoryPacker(SimpleWordTokenizer(), cfg.max_seq_length,
                         cfg.per_seq_max_length)
    stories = [[" ".join(rng.choice(WORDS, size=int(rng.integers(5, 31))))
                for _ in range(5)] for _ in range(b)]
    res = VISUAL_REF_IMAGE
    images = rng.integers(0, 256, (b, 5, res, res, 3), dtype=np.uint8)
    if kind == "berson":
        items = [packer.pack_berson_story(t, rng.permutation(5).tolist(),
                                          max_story_length=5)
                 for t in stories]
        batch = {k: np.stack([np.asarray(it[k]) for it in items])
                 for k in items[0]}
        batch.update(images=images, valid=np.ones(b, bool))
        return batch, None
    rows = [packer.pack_story(t) for t in stories]
    batch = {k: np.stack([r[i] for r in rows]) for i, k in enumerate(
        ("input_ids", "attention_mask", "token_type_ids"))}
    batch["images"] = images
    if kind == "pretrain":
        batch["input_ids"], batch["mlm_labels"] = mask_tokens_sentence(
            batch["input_ids"], mlm_probability=0.15, pad_id=cfg.pad_id,
            cls_id=cfg.cls_id, mask_id=cfg.mask_id,
            vocab_size=cfg.encoder.vocab_size,
            ignore_index=cfg.mlm_ignore_index, rng=rng)
        nb, aux = plan_objective("swapping_based_nsp", batch, cfg, rng)
        return nb, {k: v for k, v in aux.items()
                    if isinstance(v, np.ndarray) and v.ndim > 0}
    batch["labels"] = np.stack([rng.permutation(5) for _ in range(b)]
                               ).astype(np.int32)
    batch["valid"] = np.ones(b, bool)
    if cfg.num_img_regional_features:
        if cfg.vision_model.startswith("detectron2"):
            batch["img_regional_features"] = np.zeros((b, 1), np.float32)
        else:
            batch["img_regional_features"] = rng.standard_normal(
                (b, 5, cfg.num_img_regional_features, cfg.visual_feat_dim)
            ).astype(np.float32)
    return batch, None


def _visual_ref_run(kind, cfg, model, batch, aux, dev):
    """One device's readings: a train-mode forward (dropout 0, the towers'
    batch statistics, which it updates) with its outputs, loss terms and
    gradients; then the eval-mode decode (the heat map's order, BERSON's
    beam)."""
    import torch
    from multimodal_sequencing_tpu_torch.models.encoder import DropoutRng
    from multimodal_sequencing_tpu_torch.train.steps import (
        compute_loss, device_batch)
    from multimodal_sequencing_tpu_torch.utils.heatmap import heatmap2order
    db = device_batch(batch, dev)
    rng = DropoutRng(1, 0, dev)
    model.train()
    outs, decode = {}, None
    if kind == "seq":
        kw = ({"img_regional_features": db["img_regional_features"]}
              if "img_regional_features" in db else {})
        out = model(db["input_ids"], db["attention_mask"],
                    db["token_type_ids"], images=db["images"],
                    deterministic=False, rng=rng, **kw)
        loss, terms = compute_loss(cfg, out, db)
        outs = {"heatmap": out["heatmap"], "visual_output":
                out["visual_output"]}
        terms = {"loss": loss, **terms}
    elif kind == "berson":  # (its pointer logits hold -1e9 masks)
        out = model(db, deterministic=False, rng=rng)
        loss = out["loss"]
        terms = {k: v for k, v in out.items()
                 if k.endswith("loss") and v.dim() == 0}
    else:
        out = model(db, "swapping_based_nsp", device_batch(aux, dev),
                    deterministic=False, rng=rng)
        loss, terms = out["loss"], out
    loss.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    got = {k: v.detach().double().cpu() for k, v in outs.items()}
    got.update({k: float(v) for k, v in terms.items()})
    stats = _bn_stats(model)
    model.eval()
    with torch.no_grad():
        if kind == "seq":
            hm = model(db["input_ids"], db["attention_mask"],
                       db["token_type_ids"], images=db["images"], **kw
                       )["heatmap"].float().cpu().numpy()
            decode = (hm, [heatmap2order(h) for h in hm])
        elif kind == "berson":
            decode = (None, model.beam_search(db).cpu().tolist())
    return got, grads, stats, decode


def phase_visual_reference(seed: int):
    """The models of `visual_path` at full RoBERTa-large width with 2
    layers, f32, dropout 0 (BERSON's paragraph encoder's too), towers
    frozen (their train-mode f32 gradients
    are ill-conditioned; the CPU tests hold them to an f64 run): resnet18
    and R-18 FPN towers at 64 px, K = 3. Card (kernels) against the CPU
    (plain versions) on the same weights and inputs: the outputs, every
    loss term, every gradient over the global norm, the BatchNorm
    statistics a train-mode forward updates, and the decodes (the heat
    maps' orders, up to ties of DECODE_TIE_REL; BERSON's beam) equal."""
    import copy
    import torch
    from multimodal_sequencing_tpu_torch.data.tokenization import (
        SimpleWordTokenizer)
    from multimodal_sequencing_tpu_torch.models.berson import BersonOrdering
    from multimodal_sequencing_tpu_torch.models.config import (
        EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.pretrainer import (
        SequencingPretrainer)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    tok = SimpleWordTokenizer()
    readings, ok = {}, True
    torch.backends.cudnn.deterministic = True
    try:
        for name, kind, change in _visual_ref_cases():
            cfg = MultimodalConfig(
                encoder=EncoderConfig.roberta_large(
                    type_vocab_size=5, vocab_size=len(tok),
                    num_hidden_layers=2, dtype="float32",
                    hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0),
                hierarchical_version="v1", max_seq_length=160,
                per_seq_max_length=32, multimodal=True,
                image_size=(VISUAL_REF_IMAGE,) * 2, freeze_vision_model=True,
                cls_id=tok.cls_token_id, pad_id=tok.pad_token_id,
                mask_id=tok.mask_token_id, **change)
            build = {"seq": SequencingModel, "berson": BersonOrdering,
                     "pretrain": SequencingPretrainer}[kind]
            cpu = init_weights(build(cfg), seed)
            if kind == "berson":
                cpu.para_encoder.dropout = 0.0  # its own 0.1 otherwise
            card = copy.deepcopy(cpu).cuda()
            batch, aux = _visual_ref_inputs(kind, cfg, seed)
            (want, gw, sw, dw), (got, gg, sg, dg) = (
                _visual_ref_run(kind, cfg, m, batch, aux, dev)
                for m, dev in ((cpu, "cpu"), (card, "cuda")))
            norm = math.sqrt(sum(g.norm().item() ** 2 for g in gw.values()))
            reading = {
                "output": max([_rel_to_max(got[k], w) for k, w in want.items()
                               if torch.is_tensor(w)] or [0.0]),
                "loss": max(abs(got[k] - w) / max(abs(w), 1e-30)
                            for k, w in want.items() if not torch.is_tensor(w)),
                "grad_rel_to_norm": max((gg[n] - g).norm().item() / norm
                                        for n, g in gw.items()),
                "bn_stats": max(_rel_to_max(sg[n], s) for n, s in sw.items())}
            decode_ok = True
            if dw is not None:
                hm, orders = dw
                for i, (a, c) in enumerate(zip(orders, dg[1])):
                    if a == c:
                        continue
                    if hm is None:  # BERSON's beam: equal orders
                        decode_ok = False
                        continue
                    sa = _decode_score(hm[i], a, "naive_v2_sum")
                    sc = _decode_score(hm[i], c, "naive_v2_sum")
                    decode_ok = decode_ok and (
                        abs(sa - sc) <= DECODE_TIE_REL * abs(sa))
            readings[name] = {**reading, "decodes_equal": decode_ok,
                              "loss_terms": {k: w for k, w in want.items()
                                             if not torch.is_tensor(w)},
                              "grads_compared": len(gw),
                              "bn_stats_compared": len(sw)}
            ok = (ok and decode_ok and set(gg) == set(gw) and sw
                  and all(v <= VISUAL_REF_TOL[k] for k, v in reading.items()))
            del cpu, card
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "visual_reference", "layers": 2, "dtype": "float32",
          "seed": seed, "image": VISUAL_REF_IMAGE, "k": VISUAL_REF_K,
          "readings": readings, "tol": VISUAL_REF_TOL, "ok": bool(ok)})
    if not ok:
        raise AssertionError("card and CPU disagree on the visual models")


def write_sidecars(images: dict, k: int, width: int, seed: int) -> None:
    """A `{img}_maskrcnn.npy` beside each image: a pickled dict with
    `features` of (k, width) f32, as `data/images.py::load_maskrcnn_sidecar`
    reads it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for path in sorted(images):
        feats = rng.standard_normal((k, width)).astype(np.float32)
        np.save(os.path.splitext(path)[0] + "_maskrcnn.npy",
                {"features": feats}, allow_pickle=True)


def _vb_argv(data_dir, out_dir, seed, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_train_batch_size", "8",
            "--learning_rate", "1e-5", "--warmup_steps", "2",
            "--max_steps", str(VB_STEPS), "--logging_steps", "1",
            "--save_steps", "0", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--eval_splits", "test", "--per_gpu_eval_batch_size", "8",
            "--multimodal", "--device", "cuda", *extra]


# the fine-tune runs of `visual_path`: (label, flags, data with sidecars,
# launches a forward, visual tokens a story)
VB_RUNS = (
    ("vb_train", ("--multimodal_model_type", "visualbert", "--vision_model",
                  "resnet50", "--include_num_img_regional_features",
                  str(VB_K), "--do_eval", "--eval_save_all_results"),
     True, VB_PER_FORWARD, VB_S - 320),
    ("vb_fpn_train", ("--multimodal_model_type", "visualbert",
                      "--vision_model", "detectron2_R_50_FPN",
                      "--vision_image_size", str(FPN_IMAGE),
                      "--include_num_img_regional_features", str(VB_K)),
     False, VB_PER_FORWARD, NAIVE_S - 320),
    ("naive_train", ("--multimodal_model_type", "naive", "--vision_model",
                     "resnet50"), False, NAIVE_PER_FORWARD, NAIVE_S - 320))


def _visual_lengths(lengths: list):
    """Record the visual stream's length of every VisualBERT forward and
    of every naive forward (the tokens after the text) in `lengths`;
    returns the undo."""
    from multimodal_sequencing_tpu_torch.models import naive_model, visualbert
    enc = visualbert.VisualBERTEncoder.encode_visual
    naive = naive_model.NaiveMultimodalModel.forward

    def encode_visual(self, *a, **kw):
        out = enc(self, *a, **kw)
        lengths.append(out.shape[1])
        return out

    def forward(self, input_ids, *a, **kw):
        out = naive(self, input_ids, *a, **kw)
        lengths.append(out["sequence_output"].shape[1] - input_ids.shape[1])
        return out

    visualbert.VisualBERTEncoder.encode_visual = encode_visual
    naive_model.NaiveMultimodalModel.forward = forward

    def undo():
        visualbert.VisualBERTEncoder.encode_visual = enc
        naive_model.NaiveMultimodalModel.forward = naive
    return undo


def _visual_run_summary(label, res, train, want, saves, lengths, tokens):
    import torch
    step_s = _berson_steps(res)
    return {"phase": "visual_path", "part": label,
            "steps": res.global_step, "launches": train,
            "launches_predicted": want,
            "losses": [h["loss"] for h in res.history], "step_s": step_s,
            "median_step_s_after_first": _median_after_first(step_s),
            "visual_tokens": sorted(set(lengths)),
            "visual_tokens_predicted": tokens,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "saves_recorded": saves,
            "bytes_written_so_far": bytes_written()}


def _counts_exact(counts, want):
    return (all(counts[k] == v for k, v in want.items())
            and all(counts[k] == 0 for k in F32_BWD))


def phase_visual_path(seed: int, work: str):
    """VisualBERT and the naive model through the CLIs at RoBERTa-large
    (24 layers, bf16, dropout 0.1, random weights from `--seed`) on
    synthetic WikiHow stories with PNG step images: (a) `main_train` of
    VisualBERT over RN50 at 224 px with K = 10 regional tokens a step from
    the `{img}_maskrcnn.npy` sidecars this phase writes ((10, 2048) f32),
    4 steps of 8 stories (S = 375), then `--do_eval` of 16 stories
    (heat-map sort, micro-batch 32); (b) the same over the R-50 FPN tower
    at 256 px with no sidecars on disk: the datasets' sentinel, so one
    token an image (S = 325) and no inline ROI, as in the JAX package;
    (c) the naive model over RN50 (S = 325); (d) BERSON over VisualBERT at
    the launcher's configuration (1 story of 20 pairs a step, S = 122), 2
    steps and a beam-16 eval of 1 story; (e) `main_pretrain` of VisualBERT
    over the R-50 FPN tower at 256 px with inline ROI (K + 1 = 11
    proposals an image, S = 355), swapping_based_nsp with MLM, 2 steps of
    4 stories. Each: exact launches (train and eval apart), the visual
    tokens of every forward, finite losses, the median step, peak memory;
    no save is written (each is recorded)."""
    import torch
    from multimodal_sequencing_tpu_torch.train import cli
    data = os.path.join(work, "vb_data")
    bare = os.path.join(work, "vb_bare")
    for d in (data, bare):
        os.makedirs(d)
    images = write_wikihow(data, "train", 8 * VB_STEPS, seed + 51,
                           images=True)
    images.update(write_wikihow(data, "test", VB_EVAL_STORIES, seed + 52,
                                images=True))
    write_sidecars(images, VB_K, 2048, seed + 53)
    write_wikihow(bare, "train", 8 * VB_STEPS, seed + 54, images=True)
    counts, evaluators, lengths = _EvalCounts(), [], []
    make_eval, make_evaluator = cli._make_dev_eval_fn, cli._evaluator
    make_berson_eval = cli._make_berson_eval_fn

    def counted_eval(*a, **kw):
        fn = make_eval(*a, **kw)
        return None if fn is None else counts.wrap(fn)

    def counted_berson_eval(*a, **kw):
        fn = make_berson_eval(*a, **kw)
        return None if fn is None else counts.wrap(fn)

    def recorded_evaluator(*a, **kw):
        evaluators.append(make_evaluator(*a, **kw))
        return evaluators[-1]

    launches = {}
    undo = _visual_lengths(lengths)
    cli._make_dev_eval_fn, cli._evaluator = counted_eval, recorded_evaluator
    cli._make_berson_eval_fn = counted_berson_eval
    try:
        for label, flags, sidecars, per, tokens in VB_RUNS:
            out_dir = os.path.join(work, label)
            counts.reset()
            evaluators.clear()
            lengths.clear()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            saves = []
            with _saves_not_written(saves):
                res = cli.main_train(_vb_argv(data if sidecars else bare,
                                              out_dir, seed, *flags))
            train, evals = counts.split()
            want = _expected(per, VB_STEPS, VB_STEPS, PATH_KERNELS["train"])
            train_lengths = lengths[:VB_STEPS]
            summary = _visual_run_summary(label, res, train, want, saves,
                                          train_lengths, tokens)
            ok = (res.global_step == VB_STEPS
                  and all(math.isfinite(h["loss"]) for h in res.history)
                  and _counts_exact(train, want)
                  and train_lengths == [tokens] * VB_STEPS
                  and saves == [(os.path.abspath(out_dir), VB_STEPS, None)])
            launches[label] = train
            if "--do_eval" in flags:
                ev = evaluators[0]
                forwards = math.ceil(VB_EVAL_STORIES / 8)
                want_eval = _expected(per, forwards, 0, PATH_KERNELS["eval"])
                fwd, dec = ev.forward_seconds, ev.decode_seconds
                perms = _check_eval_outputs(out_dir, VB_EVAL_STORIES)
                summary.update(
                    eval_forwards=ev.forwards, eval_launches=evals,
                    eval_launches_predicted=want_eval,
                    eval_visual_tokens=sorted(set(lengths[VB_STEPS:])),
                    eval_all_permutations=perms,
                    eval_median_batch_s=_median_after_first(
                        [f + d for f, d in zip(fwd, dec)]),
                    eval_median_forward_s=_median_after_first(fwd),
                    eval_metrics=res.eval_results)
                ok = (ok and ev.forwards == forwards and perms
                      and lengths[VB_STEPS:] == [tokens] * forwards
                      and all(evals[k] == v for k, v in want_eval.items())
                      and list(res.eval_results)
                      == [f"checkpoint-{VB_STEPS}"])
                launches["vb_eval"] = evals
            emit(summary)
            if not ok:
                raise AssertionError(f"{label} check failed: {summary}")
            del res
            torch.cuda.empty_cache()
        launches.update(_visual_berson(seed, work, counts, lengths))
        launches.update(_visual_pretrain(seed, work, lengths))
    finally:
        undo()
        cli._make_dev_eval_fn, cli._evaluator = make_eval, make_evaluator
        cli._make_berson_eval_fn = make_berson_eval
    return launches


def _visual_berson(seed, work, counts, lengths):
    """(d): BERSON over VisualBERT (RN50, 224 px) at the launcher's
    configuration, 2 steps of one 5-step story (20 pairs of 120 text tokens
    and 2 image tokens), then `--do_eval`'s beam-16 eval of one test story
    on the model in memory."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import main_train
    data = os.path.join(work, "vb_berson_data")
    os.makedirs(data)
    write_wikihow(data, "train", VB_BERSON_STEPS, seed + 55, images=True)
    write_wikihow(data, "test", 1, seed + 56, images=True)
    out_dir = os.path.join(work, "vb_berson")
    counts.reset()
    lengths.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    saves = []
    with _saves_not_written(saves):
        res = main_train(_berson_train_argv(
            data, out_dir, seed, "--multimodal", "--multimodal_model_type",
            "visualbert", "--vision_model", "resnet50",
            "--per_gpu_train_batch_size", "1", "--per_gpu_eval_batch_size",
            "1", "--learning_rate", "5e-6", "--order_criteria", "loose",
            "--max_steps", str(VB_BERSON_STEPS), "--save_steps", "0",
            "--do_eval", "--eval_splits", "test", "--beam_size", "16"))
    train, evals = counts.split()
    want = _expected(VB_BERSON_PER_FORWARD, VB_BERSON_STEPS,
                     VB_BERSON_STEPS, PATH_KERNELS["train"])
    want_eval = _expected(VB_BERSON_PER_FORWARD, 1, 0, PATH_KERNELS["eval"])
    tokens = 2
    summary = _visual_run_summary("vb_berson_train", res, train, want, saves,
                                  lengths, tokens)
    results = res.eval_results.get(f"checkpoint-{VB_BERSON_STEPS}", {})
    metrics_ok = list(results) == ["test"] and all(
        math.isfinite(v) for v in results["test"].values())
    summary.update(eval_launches=evals, eval_launches_predicted=want_eval,
                   eval_results=results)
    emit(summary)
    ok = (res.global_step == VB_BERSON_STEPS
          and all(math.isfinite(h["loss"]) for h in res.history)
          and _counts_exact(train, want)
          and all(evals[k] == v for k, v in want_eval.items())
          and lengths == [tokens] * (VB_BERSON_STEPS + 1)
          and saves == [(os.path.abspath(out_dir), VB_BERSON_STEPS, None)]
          and metrics_ok)
    if not ok:
        raise AssertionError(f"vb_berson check failed: {summary}")
    return {"vb_berson_train": train, "vb_berson_eval": evals}


def _visual_pretrain(seed, work, lengths):
    """(e): `main_pretrain` of VisualBERT over the R-50 FPN tower at 256
    px with inline ROI (K = 10; the pretrainer passes no sidecars), the
    swapping_based_nsp objective with MLM, 2 steps of 4 stories."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import main_pretrain
    data = os.path.join(work, "vb_pretrain_data")
    os.makedirs(data)
    write_wikihow(data, "train", 4 * VB_PRETRAIN_STEPS, seed + 57,
                  images=True)
    out_dir = os.path.join(work, "vb_pretrain")
    lengths.clear()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    saves = []
    with _saves_not_written(saves):
        res = main_pretrain([
            "--model_name_or_path", "simple", "--model_size", "large",
            "--do_train", "--data_dirs", data, "--data_names", "wikihow",
            "--max_seq_length", "300", "--per_seq_max_length", "60",
            "--per_gpu_train_batch_size", "4", "--learning_rate", "1e-5",
            "--warmup_steps", "1", "--max_steps", str(VB_PRETRAIN_STEPS),
            "--logging_steps", "1", "--save_steps", "0", "--seed", str(seed),
            "--multimodal", "--multimodal_model_type", "visualbert",
            "--vision_model", "detectron2_R_50_FPN", "--vision_image_size",
            str(FPN_IMAGE), "--include_num_img_regional_features", str(VB_K),
            "--multimodal_pretrain_objectives", "swapping_based_nsp",
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda"])
    counts = _read_counts()
    want = _expected(VB_PRETRAIN_PER_FORWARD, VB_PRETRAIN_STEPS,
                     VB_PRETRAIN_STEPS, PATH_KERNELS["train"])
    tokens = VB_PRETRAIN_S - 300
    summary = _visual_run_summary("vb_pretrain", res, counts, want, saves,
                                  lengths, tokens)
    summary["loss_terms"] = [{k: h.get(k) for k in ("mlm",
                                                    "swapping_based_nsp")}
                             for h in res.history]
    emit(summary)
    ok = (res.global_step == VB_PRETRAIN_STEPS
          and all(math.isfinite(h["loss"]) for h in res.history)
          and _counts_exact(counts, want)
          and lengths == [tokens] * VB_PRETRAIN_STEPS
          and saves == [(os.path.abspath(out_dir), VB_PRETRAIN_STEPS, None)])
    if not ok:
        raise AssertionError(f"vb_pretrain check failed: {summary}")
    return {"vb_pretrain": counts}


# ----- the parallel layer and the tools ---------------------------------------

PARALLEL_STEPS = 3   # parallel_path: main_train steps of 8 stories
# the wrapped runs against the single process: the same bf16 arithmetic on
# one rank. The two unwrapped runs must be bit-equal (every kernel sums in
# a fixed order; the flash backward's dq partials are added in turn). Each
# wrapped run's largest relative difference must be within
# PARALLEL_SPREAD_X times that of the two unwrapped runs, or within
# PARALLEL_FLOOR (set when the dq adds came in a varying order, at ~1.5x
# and ~3x the largest spreads seen then: 1.3e-3 in the third loss, 1.7e-4
# in a gradient norm); the first two losses, before any weight moves (the
# first update's learning rate is 0), must be equal
PARALLEL_SPREAD_X = 4.0
PARALLEL_FLOOR = {"loss_rel": 2e-3, "grad_norm_rel": 5e-4}
PARALLEL_TIMEOUT_S = 600
TOOLS_STORIES = 4    # tools_path: 4 stories of 5 step images
TOOLS_K = 10         # ROI sidecars an image
TOOLS_CPU_IMAGES = 2  # held against the CPU port in f32
TOOLS_CPU_TOL = 1e-4  # of the largest feature (MM_TOWER_TOL's limit)
PROFILE_STEPS = 5    # the --profile_dir run: its window is steps 2-4
# the kernels a --profile_dir trace must hold by name (KERNEL_CLASSES)
PROFILE_KERNELS = ("flash_fwd", "flash_bwd_", "layer_norm_fwd",
                   "layer_norm_bwd", "gelu_kernel")


def _parallel_argv(data_dir, out_dir, seed, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--do_train",
            "--task_name", "wikihow_hl_v1", "--hierarchical_version", "v1",
            "--data_dir", data_dir, "--max_seq_length", "320",
            "--per_seq_max_length", "60", "--per_gpu_train_batch_size", "8",
            "--learning_rate", "1e-5", "--warmup_steps", "1",
            "--max_steps", str(PARALLEL_STEPS), "--logging_steps", "1",
            "--save_steps", "0", "--seed", str(seed),
            "--output_dir", out_dir, "--overwrite_output_dir",
            "--device", "cuda", *extra]


def _parallel_run(argv):
    """One main_train run whose saves are recorded, not written: its
    losses, gradient norms, kernel launches, median step after the first
    and peak memory."""
    import torch
    from multimodal_sequencing_tpu_torch.train.cli import main_train
    calls = []
    torch.cuda.reset_peak_memory_stats()
    with _saves_not_written(calls):
        _reset_counts()
        res = main_train(argv)
        counts = _read_counts()
    times = [res.start_time] + [h["time"] for h in res.history]
    return res, {"losses": [h["loss"] for h in res.history],
                 "grad_norms": [h["grad_norm"] for h in res.history],
                 "steps": res.global_step, "launches": counts,
                 "median_step_s": _median_after_first(
                     [b - a for a, b in zip(times, times[1:])]),
                 "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "saves_recorded": len(calls)}


def parallel_worker(data_dir: str, out: str, seed: int) -> int:
    """The `torchrun` side of `parallel_path`: the same fine-tune run with
    DDP and with --fsdp on this rank's card, written to `out` as JSON."""
    import torch
    import torch.distributed as dist
    from multimodal_sequencing_tpu_torch.parallel.sharding_rules import (
        parallel_of)
    results = {}
    for mode, extra in (("ddp", ()), ("fsdp", ("--fsdp",))):
        res, row = _parallel_run(_parallel_argv(
            data_dir, os.path.join(os.path.dirname(out), mode), seed,
            *extra))
        par = parallel_of(res.model)
        row.update(
            backend=dist.get_backend(), world_size=dist.get_world_size(),
            train_module=type(par.train_module).__name__,
            params_sharded=sum(1 for _, p in res.model.named_parameters()
                               if hasattr(p, "_local_tensor")),
            params_ignored=len(par.ignored))
        results[mode] = row
        del res, par
        torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()
    return 0


def _rel(got, want):
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def phase_parallel_path(seed: int, work: str):
    """Fine-tune steps at RoBERTa-large under `torchrun --nproc_per_node 1`
    on NCCL, with DDP and with FSDP2 (`--fsdp`), against the same steps in
    this process, unwrapped (run twice for its own spread): the first two
    losses equal, the rest and the gradient norms within the limits of
    PARALLEL_SPREAD_X and PARALLEL_FLOOR, and the same kernel launches a
    step; the two unwrapped runs bit-equal."""
    data_dir = os.path.join(work, "parallel_data")
    os.makedirs(data_dir, exist_ok=True)
    write_wikihow(data_dir, "train", 8 * PARALLEL_STEPS, seed)
    _, one = _parallel_run(_parallel_argv(
        data_dir, os.path.join(work, "parallel_one"), seed))
    _, again = _parallel_run(_parallel_argv(
        data_dir, os.path.join(work, "parallel_again"), seed))
    spread = {"loss_rel": _rel(again["losses"], one["losses"]),
              "grad_norm_rel": _rel(again["grad_norms"], one["grad_norms"])}
    limit = {k: max(PARALLEL_SPREAD_X * v, PARALLEL_FLOOR[k])
             for k, v in spread.items()}
    out = os.path.join(work, "parallel.json")
    import torch
    torch.cuda.empty_cache()  # the card's memory for the torchrun rank
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--parallel_worker", data_dir, out, str(seed)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=PARALLEL_TIMEOUT_S)
    torchrun_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        raise AssertionError(f"torchrun exited with {proc.returncode}")
    with open(out) as f:
        runs = json.load(f)
    summary = {"phase": "parallel_path", "unwrapped": one,
               "unwrapped_again": again, "spread": spread, "limit": limit,
               "torchrun_s": torchrun_s}
    summary["unwrapped_bit_equal"] = (
        again["losses"] == one["losses"]
        and again["grad_norms"] == one["grad_norms"])
    ok = (one["steps"] == PARALLEL_STEPS
          and all(math.isfinite(x) for x in one["losses"])
          and summary["unwrapped_bit_equal"])
    for mode, row in runs.items():
        row["loss_rel_err"] = _rel(row["losses"], one["losses"])
        row["grad_norm_rel_err"] = _rel(row["grad_norms"], one["grad_norms"])
        row["launches_per_step_equal"] = all(
            row["launches"][k] * one["steps"] == one["launches"][k]
            * row["steps"] for k in one["launches"])
        ok = ok and (row["steps"] == PARALLEL_STEPS
                     and row["backend"] == "nccl"
                     and row["losses"][:2] == one["losses"][:2]
                     and row["loss_rel_err"] <= limit["loss_rel"]
                     and row["grad_norm_rel_err"] <= limit["grad_norm_rel"]
                     and row["launches_per_step_equal"])
        summary[mode] = row
    ok = ok and (runs["ddp"]["train_module"] == "DistributedDataParallel"
                 and runs["fsdp"]["params_sharded"] > 0)
    summary["ok"] = ok
    emit(summary)
    if not ok:
        raise AssertionError(f"parallel path check failed: {summary}")
    return {"parallel_one": one["launches"],
            **{f"parallel_{m}": r["launches"] for m, r in runs.items()}}


def _trace_kernel_names(path: str) -> set:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def phase_tools_path(seed: int, work: str):
    """The feature extractors on the card over a synthetic WikiHow split
    (the CLIP RN50 tower at 224 px; the ResNet-50-FPN ROI tower at 256 px,
    K = 10), a few images against the CPU port in f32, the sidecars read
    back by `load_maskrcnn_sidecar`; then a `--profile_dir` train run whose
    trace must hold the hand-written kernels by name."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data.images import (
        load_maskrcnn_sidecar)
    from multimodal_sequencing_tpu_torch.tools import (
        extract_img_features as img_tool, extract_roi_features as roi_tool)
    from multimodal_sequencing_tpu_torch.utils.profiling import TRACE_NAME
    data_dir = os.path.join(work, "tools_data")
    os.makedirs(data_dir, exist_ok=True)
    write_wikihow(data_dir, "train", TOOLS_STORIES, seed, images=True)
    paths = img_tool.collect_story_image_paths(data_dir, "wikihow", "train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = img_tool.extract_features(paths, "RN50", (224, 224), 32,
                                      device="cuda", seed=seed)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = roi_tool.extract_roi_sidecars(paths, TOOLS_K, "resnet50", (256, 256),
                                      16, seed, device="cuda")
    torch.cuda.synchronize()
    roi_s = time.perf_counter() - t0
    sidecars = {p: np.load(os.path.splitext(p)[0] + "_maskrcnn.npy",
                           allow_pickle=True).item() for p in paths}
    read_back = all(
        load_maskrcnn_sidecar(p, TOOLS_K).shape == (TOOLS_K, 2048)
        and np.array_equal(load_maskrcnn_sidecar(p, TOOLS_K),
                           sidecars[p]["features"][:TOOLS_K])
        for p in paths)
    finite = all(np.isfinite(f).all() for f in feats.values()) and all(
        np.isfinite(v).all() for d in sidecars.values() for v in d.values())
    # a few images on the CPU in f32, the same weights (drawn from the seed
    # on the CPU)
    few = paths[:TOOLS_CPU_IMAGES]
    cpu_feats = img_tool.extract_features(few, "RN50", (224, 224), 32,
                                          device="cpu", seed=seed)
    feat_err = max(_rel_to_max_np(feats[p], cpu_feats[p]) for p in few)
    tower = roi_tool.build_roi_extractor(TOOLS_K, "resnet50", (256, 256),
                                         seed, device="cpu")
    cpu_dir = os.path.join(work, "tools_cpu")
    os.makedirs(cpu_dir, exist_ok=True)
    cpu_paths = []
    for p in few:
        q = os.path.join(cpu_dir, os.path.basename(p))
        with open(p, "rb") as src, open(q, "wb") as dst:
            dst.write(src.read())
        cpu_paths.append(q)
    roi_tool.extract_roi_sidecars(cpu_paths, TOOLS_K, "resnet50", (256, 256),
                                  16, seed, device="cpu", tower=tower)
    score_err, roi_err, rows_same_box = 0.0, 0.0, 0
    for p, q in zip(few, cpu_paths):
        card = sidecars[p]
        cpu = np.load(os.path.splitext(q)[0] + "_maskrcnn.npy",
                      allow_pickle=True).item()
        score_err = max(score_err, _rel_to_max_np(card["scores"],
                                                  cpu["scores"]))
        # the features of the proposals both chose (a near-tie of scores
        # may pick another box)
        same = np.all(card["boxes"] == cpu["boxes"], axis=-1)
        rows_same_box += int(same.sum())
        if same.any():
            roi_err = max(roi_err, _rel_to_max_np(card["features"][same],
                                                  cpu["features"][same]))
    # --profile_dir through the train CLI at RoBERTa-large
    trace_dir = os.path.join(work, "trace")
    _, prof = _parallel_run([
        *_parallel_argv(data_dir, os.path.join(work, "profile_out"), seed),
        "--max_steps", str(PROFILE_STEPS), "--profile_dir", trace_dir])
    names = _trace_kernel_names(os.path.join(trace_dir, TRACE_NAME))
    found = {k: sum(1 for nm in names if k in nm) for k in PROFILE_KERNELS}
    summary = {"phase": "tools_path", "images": len(paths),
               "feature_dim": int(next(iter(feats.values())).shape[0]),
               "extract_s": feat_s, "roi_s": roi_s, "sidecars": n,
               "sidecars_read_back": read_back, "finite": finite,
               "cpu_images": len(few),
               "feature_err_of_max_vs_cpu": feat_err,
               "roi_score_err_of_max_vs_cpu": score_err,
               "roi_feature_err_of_max_vs_cpu": roi_err,
               "roi_rows_same_box": rows_same_box,
               "tolerance_of_max": TOOLS_CPU_TOL,
               "profile_steps": prof["steps"],
               "trace_kernel_names": len(names),
               "trace_kernels_found": found}
    ok = (n == len(paths) and read_back and finite
          and feat_err <= TOOLS_CPU_TOL and score_err <= TOOLS_CPU_TOL
          and roi_err <= TOOLS_CPU_TOL and rows_same_box > 0
          and prof["steps"] == PROFILE_STEPS
          and all(found.values()))
    summary["ok"] = ok
    emit(summary)
    if not ok:
        raise AssertionError(f"tools path check failed: {summary}")
    return {"tools_profile": prof["launches"]}


# ----- the pipeline and ring attention -----------------------------------------

PP_STEPS = 3                        # pipeline_path: train steps a run
PP_FINETUNE = ((2, 2), (4, 4))      # (stages, microbatches) of the fine-tune
PP_BERSON = (2, 2)                  # ... and of BERSON's text trunk
PP_BERSON_LENS = (5, 3)             # BERSON's 2 stories' live steps
RING_SHAPE = (2, 16, 4096, 64)      # (B, H, S, D) of the ring attention
RING_SIZE = 4                       # its positions in bf16 (blocks of 1024)
RING_SIZE_F32 = 2                   # ... and in f32
# the pipelined runs against the unpipelined one: within
# PARALLEL_SPREAD_X times two unpipelined runs' spread or PP_FLOOR. The
# third step's gradient norm is the noisiest reading (the atomic adds of
# the first steps, amplified by an update): two unpipelined runs differed
# by up to 5.8e-4 and the 4 x 4 pipeline by 9.6e-4 (the 2 x 2 by 5.2e-4)
# in the first card run, losses by up to 4.5e-4; in the second the 2 x 2's
# gradient norm was 6.3e-4 off against a spread of 2.2e-4 (4x: 8.6e-4) and
# the 4 x 4's third loss 6.9e-4 off, so a floor of PARALLEL_FLOOR's 5e-4
# leaves little room; the floors are ~2x and ~3x the largest readings
PP_FLOOR = {"loss_rel": 2e-3, "grad_norm_rel": 2e-3}
# the first PP_EXACT_STEPS losses: the forward of the first step is the
# unpipelined one row for row, and the second step's weights differ from
# it only by the rounding of one update, below bf16's resolution at
# learning rate 1e-5: every card run so far gave them bit-equal, so they
# are held within PP_EXACT_LOSS_REL (a dropout keying error in these
# steps moves them far more)
PP_EXACT_STEPS = 2
PP_EXACT_LOSS_REL = 1e-6
# the kernels a layer launches in one forward and backward of one
# microbatch: a pipelined step launches them n_micro times as often
LAYER_LAUNCHES = {"flash_fwd": 1, "flash_bwd_prep": 1, "flash_bwd_main": 1,
                  "flash_bwd_post": 1, "gelu_logit_erf_fwd": 1,
                  "gelu_logit_erf_bwd": 1, "layer_norm_fwd": 2,
                  "layer_norm_bwd": 2}


def _pp_run(model, state, step_fn, batches, seed):
    """PP_STEPS train steps of `step_fn` from the weights `state` with a
    fresh AdamW: each step's loss and gradient norm, the kernel launches,
    the host time of each step (to the loss on the host) and the peak
    memory."""
    import torch
    from multimodal_sequencing_tpu_torch.train.state import AdamW
    model.load_state_dict(state)
    opt = AdamW(model, learning_rate=1e-5, warmup_steps=1,
                total_steps=PP_STEPS, weight_decay=0.01, max_grad_norm=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, norms, times = [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        out = step_fn(model, opt, batch, i, seed)
        losses.append(out["loss"].item())
        times.append(time.perf_counter() - t0)
        norms.append(out["grad_norm"].item())
    counts = _read_counts()
    row = {"losses": losses, "grad_norms": norms, "launches": counts,
           "step_s": times, "median_step_s": _median_after_first(times),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    del opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return row


def _pp_compare(name, runs, n_micro, layers, summary):
    """A pipelined run against the unpipelined ones: the first
    PP_EXACT_STEPS losses within PP_EXACT_LOSS_REL, every loss and
    gradient norm within max(PARALLEL_SPREAD_X x the two unpipelined runs'
    spread, PP_FLOOR), and exactly n_micro times the layers' kernel
    launches a step (the rest unchanged). Records the comparison in
    `summary`."""
    one, again, got = runs["unpipelined"], runs["unpipelined_again"], \
        runs[name]
    spread = {"loss_rel": _rel(again["losses"], one["losses"]),
              "grad_norm_rel": _rel(again["grad_norms"], one["grad_norms"])}
    limit = {k: max(PARALLEL_SPREAD_X * v, PP_FLOOR[k])
             for k, v in spread.items()}
    want = {k: c + PP_STEPS * (n_micro - 1) * layers
            * LAYER_LAUNCHES.get(k, 0) for k, c in one["launches"].items()}
    got.update(loss_rel_err=_rel(got["losses"], one["losses"]),
               grad_norm_rel_err=_rel(got["grad_norms"], one["grad_norms"]),
               first_losses_equal=(got["losses"][:PP_EXACT_STEPS]
                                   == one["losses"][:PP_EXACT_STEPS]),
               first_losses_rel_err=_rel(got["losses"][:PP_EXACT_STEPS],
                                         one["losses"][:PP_EXACT_STEPS]),
               launches_expected=want,
               launches_exact=got["launches"] == want)
    summary.setdefault("spread", spread)
    summary.setdefault("limit", limit)
    return (all(math.isfinite(x) for x in got["losses"])
            and got["first_losses_rel_err"] <= PP_EXACT_LOSS_REL
            and got["loss_rel_err"] <= limit["loss_rel"]
            and got["grad_norm_rel_err"] <= limit["grad_norm_rel"]
            and got["launches_exact"])


def _attention_f64(q, k, v, mask, do=None):
    """Attention in f64 (the key mask by where, -1e9), and with `do` its
    gradients by autograd: the yardstick of the ring attention check."""
    import torch
    q64, k64, v64 = (x.double().requires_grad_(do is not None)
                     for x in (q, k, v))
    logits = torch.einsum("bhsd,bhtd->bhst", q64, k64) / math.sqrt(
        q.shape[-1])
    logits = logits.masked_fill(~mask.bool()[:, None, None, :], -1e9)
    o = torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, -1), v64)
    if do is None:
        return o
    grads = torch.autograd.grad(o, (q64, k64, v64), do.double())
    return o.detach(), grads


def _ring_run(dtype, ring_size, seed):
    """Ring attention at RING_SHAPE on `ring_size` positions in one
    process, forward and backward, against the whole sequence's flash
    kernels and the f64 attention: the errors (the output within
    TOLERANCE's atol times max|O| plus its rtol, as the outputs are ~1e-2;
    gradients within BWD_TOLERANCE of their largest; both against f64 and
    against the whole-sequence kernels), a planted fault (the f64 output
    without the first key block, as a merge that lost a block gives it)
    that the output's limit must catch, the exact launches, and the times
    of both (forward + backward, CUDA events)."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.parallel.mesh import Ring
    from multimodal_sequencing_tpu_torch.parallel.ring_attention import (
        ring_attention)
    name = str(dtype).split(".")[-1]
    q, k, v, mask = make_ring_inputs(dtype, seed)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen).to("cuda", dtype)
    ring = Ring(ring_size)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def run_ring():
        o = ring_attention(qg, kg, vg, mask, ring=ring)
        return o, torch.autograd.grad(o, (qg, kg, vg), do)

    def run_whole():
        o, lse = att.flash_attention(q, k, v, mask)
        return o, att.flash_attention_bwd(q, k, v, mask, o, lse, do)

    _reset_counts()
    o, grads = run_ring()
    torch.cuda.synchronize()
    counts = _read_counts()
    r2 = ring_size * ring_size
    want_counts = ({"flash_fwd": r2, "flash_bwd_prep": ring_size,
                    "flash_bwd_main": r2, "flash_bwd_post": ring_size}
                   if dtype == torch.bfloat16 else
                   {"flash_fwd": r2, "flash_bwd_dq_f32": r2,
                    "flash_bwd_dkv_f32": r2})
    want_counts = {k_: want_counts.get(k_, 0) for k_ in counts}
    o_w, g_w = run_whole()
    o64, g64 = _attention_f64(q, k, v, mask, do)
    atol, rtol = TOLERANCE[name]
    btol, brtol = BWD_TOLERANCE[name]
    row = {"dtype": name, "ring": ring_size, "shape_bhsd": list(q.shape),
           "launches": counts, "launches_exact": counts == want_counts,
           "atol": atol, "rtol": rtol, "bwd_atol_of_max": btol,
           "bwd_rtol": brtol}
    ok = row["launches_exact"]

    def o_limit(ro):
        ro = ro.double().abs()
        return atol * ro.max().item() + rtol * ro

    for ref_name, ro, rg in (("f64", o64, g64), ("whole_flash", o_w, g_w)):
        err = (o.double() - ro.double()).abs()
        good = bool((err <= o_limit(ro)).all())
        row[f"max_abs_err_o_vs_{ref_name}"] = err.max().item()
        row[f"atol_o_vs_{ref_name}"] = atol * ro.double().abs().max().item()
        row[f"ok_o_vs_{ref_name}"] = good
        ok = ok and good
        for gname, g, w in zip(("dq", "dk", "dv"), grads, rg):
            w = w.double()
            err = (g.double() - w).abs()
            lim = btol * w.abs().max().item()
            good = bool((err <= lim + brtol * w.abs()).all())
            row[f"max_abs_err_{gname}_vs_{ref_name}"] = err.max().item()
            row[f"ok_{gname}_vs_{ref_name}"] = good
            ok = ok and good
    # the whole-sequence kernels' own distance to f64, for scale
    row["max_abs_err_o_whole_vs_f64"] = (o_w.double() - o64).abs().max().item()
    del g64
    # a planted fault: the first key block dropped from every row
    n = q.shape[2] // ring_size
    dropped = mask.clone()
    dropped[:, :n] = 0
    fault = (_attention_f64(q, k, v, dropped) - o64).abs()
    row["planted_fault_max_abs_err_o"] = fault.max().item()
    row["planted_fault_caught"] = bool((fault > o_limit(o64)).any())
    ok = ok and row["planted_fault_caught"]
    del o64, fault
    torch.cuda.empty_cache()
    row["ring_ms"] = cuda_ms(run_ring, iters=5, warmup=1)
    row["whole_flash_ms"] = cuda_ms(run_whole, iters=5, warmup=1)
    row["ok"] = ok
    return row


def phase_pipeline_path(seed: int):
    """GPipe and ring attention on the card, every ring position held by
    this one process (NCCL takes one rank a card). (a) RoBERTa-large v1
    fine-tune steps (24 layers, S = 320, batch 8, dropout 0.1, bf16),
    PP_STEPS steps at 2 stages x 2 microbatches and at 4 x 4
    (`parallel/pipeline.py::make_pipeline_train_step`) against the
    unpipelined `train_step` on the same weights and batches, run twice
    for its own spread; (b) BERSON's text trunk (pairs of 120, 2 stories)
    at 2 x 2 against `berson_train_step`, the same way; (c) ring attention
    at RING_SHAPE, bf16 on 4 positions and f32 on 2, against the
    whole-sequence flash kernels and f64. No step writes a save."""
    import torch
    from multimodal_sequencing_tpu_torch.parallel.mesh import Ring
    from multimodal_sequencing_tpu_torch.parallel.pipeline import (
        make_berson_pipeline_train_step, make_pipeline_train_step)
    from multimodal_sequencing_tpu_torch.train.steps import (
        berson_train_step, train_step)
    b, _, s, _ = TRAIN_SHAPE
    summary = {"phase": "pipeline_path", "steps": PP_STEPS}
    ok = True
    launches = {}
    # (a) the fine-tune sequencer
    cfg, model = _full_width_model(seed)
    model = model.cuda()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = [_random_batch(cfg, b, s, seed + i) for i in range(PP_STEPS)]
    layers = cfg.encoder.num_hidden_layers
    runs = {name: _pp_run(model, state, train_step, batches, seed)
            for name in ("unpipelined", "unpipelined_again")}
    fine = {"layers": layers, "batch": b, "seq": s}
    for n_stages, n_micro in PP_FINETUNE:
        name = f"pp_{n_stages}x{n_micro}"
        step, _ = make_pipeline_train_step(cfg, Ring(n_stages),
                                           n_stages, n_micro)
        runs[name] = _pp_run(model, state, step, batches, seed)
        ok = _pp_compare(name, runs, n_micro, layers, fine) and ok
        launches[f"pp_finetune_{n_stages}x{n_micro}"] = runs[name]["launches"]
    launches["pp_unpipelined"] = runs["unpipelined"]["launches"]
    fine["runs"] = runs
    summary["finetune"] = fine
    del model, state
    torch.cuda.empty_cache()
    # (b) BERSON's text trunk
    cfg, model = _berson_model(seed)
    model = model.cuda()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = [_berson_batch(seed + i, PP_BERSON_LENS)
               for i in range(PP_STEPS)]
    runs = {name: _pp_run(model, state, berson_train_step, batches, seed)
            for name in ("unpipelined", "unpipelined_again")}
    n_stages, n_micro = PP_BERSON
    step = make_berson_pipeline_train_step(cfg, Ring(n_stages),
                                           n_stages, n_micro)
    runs["pp_berson"] = _pp_run(model, state, step, batches, seed)
    berson = {"layers": cfg.encoder.num_hidden_layers,
              "pairs": BERSON_P * len(PP_BERSON_LENS), "seq": BERSON_L,
              "runs": runs}
    ok = _pp_compare("pp_berson", runs, n_micro,
                     cfg.encoder.num_hidden_layers, berson) and ok
    launches["pp_berson"] = runs["pp_berson"]["launches"]
    summary["berson"] = berson
    del model, state
    torch.cuda.empty_cache()
    # (c) ring attention
    ring = {"bf16": _ring_run(torch.bfloat16, RING_SIZE, seed),
            "f32": _ring_run(torch.float32, RING_SIZE_F32, seed)}
    launches["pp_ring"] = ring["bf16"]["launches"]
    launches["pp_ring_f32"] = ring["f32"]["launches"]
    summary["ring_attention"] = ring
    ok = ok and all(r["ok"] for r in ring.values())
    summary["ok"] = ok
    emit(summary)
    if not ok:
        raise AssertionError(f"pipeline path check failed: {summary}")
    return launches


def _rel_to_max_np(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


PHASES = ("kernel_check", "bits_check", "timing", "main_path", "breakdown",
          "reference", "train_path", "train_breakdown", "train_reference",
          "hf_path", "remat", "mm_check", "mm_reference", "mm_path",
          "mm_breakdown", "berson_reference", "berson_path",
          "pretrain_reference", "pretrain_path", "recipeqa_path",
          "baselines_reference", "baselines_path", "heads_reference",
          "heads_path", "visual_reference", "visual_path", "parallel_path",
          "pipeline_path", "tools_path")


# the card-against-CPU phases: most of their time is the CPU side, so they
# run in a second process beside the card paths (after `timing`, so no
# kernel time is read beside them), on REFERENCE_THREADS of the card
# machine's 8 cores; the card paths keep the rest (they are host-bound)
REFERENCE_PHASES = ("reference", "train_reference", "mm_check",
                    "mm_reference", "berson_reference", "pretrain_reference",
                    "baselines_reference", "heads_reference",
                    "visual_reference")
REFERENCE_THREADS = 5
REFERENCE_TIMEOUT_S = 900


def start_reference_worker(phases, seed: int, work: str):
    """This script on `phases` in a second process (`--reference_worker`),
    its output lines into a file of `work`; None without phases."""
    if not phases:
        return None
    out = open(os.path.join(work, "reference_worker.jsonl"), "w")
    cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
           "--reference_worker", "--phases", *phases]
    return subprocess.Popen(cmd, stdout=out), out


def finish_reference_worker(worker) -> list:
    """Waits for the worker, prints its lines and returns the phases that
    failed there (the worker itself where it gave no account)."""
    proc, out = worker
    try:
        proc.wait(timeout=REFERENCE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out.close()
    with open(out.name) as f:
        lines = f.read().splitlines()
    for line in lines:
        print(line, flush=True)
    try:
        failed = json.loads(lines[-1])["reference_worker_failed"]
    except (IndexError, KeyError, ValueError):
        return ["reference_worker"]
    return failed if proc.returncode == 0 else failed + ["reference_worker"]


def run_reference_worker(phases, seed: int) -> int:
    """The `--reference_worker` side: `phases` on REFERENCE_THREADS CPU
    threads, each phase's lines as in the main process, then one line
    naming those that failed."""
    import torch
    torch.set_num_threads(REFERENCE_THREADS)
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{name}"](seed)  # each takes the seed alone
        except Exception as e:  # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            failed.append(name)
        emit({"phase": name, "seconds": time.perf_counter() - t0,
              "worker": "reference"})
    emit({"reference_worker_failed": failed})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES))
    ap.add_argument("--parallel_worker", nargs=3,
                    metavar=("DATA_DIR", "OUT", "SEED"),
                    help="the torchrun side of parallel_path")
    ap.add_argument("--reference_worker", action="store_true",
                    help="run --phases (card against CPU) in this process "
                         "for the main one")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.parallel_worker:
        data_dir, out, seed = args.parallel_worker
        return parallel_worker(data_dir, out, int(seed))
    from multimodal_sequencing_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.reference_worker:
        return run_reference_worker(args.phases, args.seed)

    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t_start
    emit({"phase": "build", "card": card, "kernels": list(_build.KERNELS),
          "build_s": build_s,
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling" in ln]})

    failed = []
    errs, timing, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as work:
        run = {
            "kernel_check": lambda: phase_kernel_check(args.seed, errs),
            "bits_check": lambda: phase_bits_check(args.seed, errs),
            "timing": lambda: timing.update(phase_timing(args.seed)),
            "main_path": lambda: launches.update(eval=phase_main_path(args.seed, work)),
            "breakdown": lambda: phase_breakdown(args.seed),
            "train_path": lambda: launches.update(train=phase_train_path(args.seed, work)),
            "train_breakdown": lambda: phase_train_breakdown(args.seed),
            "hf_path": lambda: launches.update(phase_hf_path(args.seed, work)),
            "remat": lambda: phase_remat(args.seed),
            "mm_path": lambda: launches.update(phase_mm_path(args.seed, work)),
            "mm_breakdown": lambda: phase_mm_breakdown(args.seed),
            "berson_path": lambda: launches.update(
                phase_berson_path(args.seed, work)),
            "pretrain_path": lambda: launches.update(
                phase_pretrain_path(args.seed, work)),
            "recipeqa_path": lambda: launches.update(
                phase_recipeqa_path(args.seed, work)),
            "baselines_path": lambda: launches.update(
                phase_baselines_path(args.seed, work)),
            "heads_path": lambda: launches.update(
                phase_heads_path(args.seed, work)),
            "visual_path": lambda: launches.update(
                phase_visual_path(args.seed, work)),
            "parallel_path": lambda: launches.update(
                phase_parallel_path(args.seed, work)),
            "pipeline_path": lambda: launches.update(
                phase_pipeline_path(args.seed)),
            "tools_path": lambda: launches.update(
                phase_tools_path(args.seed, work)),
        }
        refs = [n for n in args.phases if n in REFERENCE_PHASES]
        own = [n for n in args.phases if n not in REFERENCE_PHASES]
        after = "timing" if "timing" in own else None
        worker = None
        try:
            if after is None:
                worker = start_reference_worker(refs, args.seed, work)
            for name in own:
                t0 = time.perf_counter()
                try:
                    run[name]()
                except Exception as e:  # report every phase, then fail
                    traceback.print_exc()
                    emit({"phase": name, "ok": False, "error": repr(e)})
                    failed.append(name)
                emit({"phase": name, "seconds": time.perf_counter() - t0,
                      "bytes_written_so_far": bytes_written()})
                if name == after:
                    worker = start_reference_worker(refs, args.seed, work)
            if worker is not None:
                t0 = time.perf_counter()
                failed += finish_reference_worker(worker)
                emit({"phase": "reference_worker_wait",
                      "seconds": time.perf_counter() - t0,
                      "bytes_written_so_far": bytes_written()})
        finally:
            if worker is not None and worker[0].poll() is None:
                worker[0].kill()
                worker[0].wait()
    for path, names in PATH_KERNELS.items():
        if path in launches and any(launches[path][k] == 0 for k in names):
            failed.append(f"{path} path launched a kernel of its path no time")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        counter = COUNTER.get(name, name)
        path = ROW_PATH.get(name, "train")
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "max_abs_err": errs.get(name, timing.get(name, {}).get(
                   "max_abs_err")),
               "launches": launches.get(path, {}).get(counter, 0)}
        row.update({k: timing.get(name, {}).get(k) for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        out = {k: row.get(k) for k in order}
        out["launches_by_path"] = {p: c.get(counter, 0)
                                   for p, c in launches.items()}
        if name in ROW_PATH:  # the counter is shared by every shape
            out["launches_counted"] = f"{counter} on {path}, every shape"
        rows.append(out)
    emit({"kernels": rows})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if tuple(args.phases) != PHASES:
        print("chip_smoke: a subset of the phases ran", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
