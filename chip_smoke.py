#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--phases NAME ...]

Run from the root of the repository. It builds the port's CUDA kernels from
the sources in the checkout, holds each kernel against its plain PyTorch
version on the card, times it, and drives the port's two main paths at the
full RoBERTa-large width on `cuda`: the heat-map sort evaluation
(`trainers.eval --sort_method heat_map`, through `run_eval`) and fine-tuning
(`trainers.train --hierarchical_version v1`, through `main_train`), whose
checkpoint the evaluation then loads. Every output line before the last is
one JSON object (plus the raw `nvidia-smi` line and the paper-format eval
rows); the last line is the contract line `{"ok": true, "device": {...}}`,
printed only when every phase passed. Without a CUDA device, or without the
port's package beside it, it exits non-zero and prints no result.
`--phases` runs a subset (the build always runs); the contract line then
is not printed.
"""

from __future__ import annotations

import argparse
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
# 64-key tiles at S = 1024, the tiny test config's head dim 16, and the
# train shape (batch 8)
KERNEL_SHAPES = [(32, 16, 320, 64), (4, 16, 566, 64), (2, 16, 1024, 64),
                 (2, 4, 40, 16), (8, 16, 320, 64)]
EVAL_SHAPE, TRAIN_SHAPE = KERNEL_SHAPES[0], KERNEL_SHAPES[-1]
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
NUM_LAYERS = 24  # RoBERTa-large: one attention call per layer per forward
N_STORIES = 40   # eval: 5 batches of 8
TRAIN_STEPS = 8  # train: steps of 8 stories
BITS_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/keep_bits_dump.cu"
GELU_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/gelu.cu"
BWD_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/flash_bwd.cu"
LN_KERNEL = "multimodal_sequencing_tpu_torch/ops/csrc/layer_norm.cu"
KERNELS = {
    "flash_fwd": ("multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
                  "multimodal_sequencing_tpu/ops/attention.py:126"),
    # the whole bf16 backward (pre-pass, main kernel, post-pass)
    "flash_bwd": (BWD_KERNEL, "multimodal_sequencing_tpu/ops/attention.py:343"),
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
                           "multimodal_sequencing_tpu/ops/gelu.py:162"),
    "gelu_logit_erf_bwd": (GELU_KERNEL,
                           "multimodal_sequencing_tpu/ops/gelu.py:175"),
    # nor the Flax LayerNorm the JAX encoder calls (models/encoder.py:146)
    "layer_norm_fwd": (LN_KERNEL,
                       "multimodal_sequencing_tpu/models/encoder.py:146"),
    "layer_norm_bwd": (LN_KERNEL,
                       "multimodal_sequencing_tpu/models/encoder.py:146"),
}
# the kernels each main path must launch
PATH_KERNELS = {"eval": ("flash_fwd", "gelu_logit_erf_fwd", "layer_norm_fwd"),
                "train": ("flash_fwd", "flash_bwd_prep", "flash_bwd_main",
                          "flash_bwd_post", "gelu_logit_erf_fwd",
                          "gelu_logit_erf_bwd", "layer_norm_fwd",
                          "layer_norm_bwd")}
# the launch counter behind each row of the `kernels` line, where it is
# not the row's own name
COUNTER = {"flash_bwd": "flash_bwd_main", "flash_bwd_dq": "flash_bwd_main",
           "flash_bwd_dkv": "flash_bwd_main",
           "keep_bits_dump@verify": "keep_bits_dump"}
# the f32 backward kernels: the check path, never launched by the bf16
# train path
F32_BWD = ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")
# launches of each path kernel per forward (LayerNorm: 2 per layer + the
# embeddings')
PER_FORWARD = {"layer_norm_fwd": 49, "layer_norm_bwd": 49}
# LayerNorm inputs: (rows, features, mean); rows of std 1 around `mean`
LN_SHAPES = [(32 * 320, 1024, 0.0), (8 * 320, 1024, 0.0), (8 * 320, 1024, 3.0),
             (7, 64, 0.0)]
# |got - want| <= atol + rtol * |want| (dw, db: atol relative to the largest
# entry). f32: the same formula, f32 sums in another order; bf16: one bf16
# ulp of the output, and dx is rounded from f32 in both.
LN_TOLERANCE = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7)}
# the MLP activation entering the GELU: (tokens, intermediate size)
GELU_SHAPES = [(32 * 320, 4096), (8 * 320, 4096), (5, 7)]
# |got - want| <= atol + rtol * |want|. f32: the kernel and the plain
# version round the same f32 formula in other places (fused multiply-adds
# outside the polynomials), an ulp of sigma and u' that the backward's
# x sigma (1 - sigma) u' magnifies up to ~10x; bf16: one bf16 ulp.
GELU_TOLERANCE = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}

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


def phase_kernel_check(seed: int, errs: dict):
    """Forward and backward kernels against the plain versions at every
    shape, dtype and dropout rate; bwd inputs are the kernel forward's O and
    lse and a random dO."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    failed = []
    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for p in (0.0, DROPOUT_P):
                q, k, v, mask = make_attention_inputs(shape, dtype, seed)
                o, lse = att.flash_attention(q, k, v, mask, p, seed + 17)
                torch.cuda.synchronize()
                o_ref, lse_ref = att.attention_reference_lse(q, k, v, mask, p,
                                                             seed + 17)
                atol, rtol = TOLERANCE[name]
                ok = all(bool(((got.float() - want.float()).abs()
                               <= atol + r * want.float().abs()).all())
                         for got, want, r in ((o, o_ref, rtol),
                                              (lse, lse_ref, 0.0)))
                row = {"phase": "kernel_check", "kernel": "flash_fwd",
                       "shape_bhsd": list(shape), "dtype": name,
                       "dropout_p": p, "max_abs_err_o": _max_err(o, o_ref),
                       "max_abs_err_lse": _max_err(lse, lse_ref),
                       "atol": atol, "rtol": rtol, "ok": ok}
                emit(row)
                failed += [] if ok else [("flash_fwd", shape, name, p)]

                gen = torch.Generator(device="cpu").manual_seed(seed + 1)
                do = torch.randn(shape, generator=gen).to("cuda", dtype)
                got = att.flash_attention_bwd(q, k, v, mask, o, lse, do, p,
                                              seed + 17)
                torch.cuda.synchronize()
                want = att.attention_bwd_reference(q, k, v, mask, o, lse, do,
                                                   p, seed + 17)
                btol, brtol = BWD_TOLERANCE[name]
                row = {"phase": "kernel_check", "kernel": "flash_bwd",
                       "shape_bhsd": list(shape), "dtype": name,
                       "dropout_p": p, "atol_of_max": btol, "rtol": brtol}
                for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                    lim = btol * w.float().abs().max().item()
                    good = bool(((g.float() - w.float()).abs()
                                 <= lim + brtol * w.float().abs()).all())
                    row[f"max_abs_err_{gname}"] = _max_err(g, w)
                    row[f"max_abs_{gname}"] = w.float().abs().max().item()
                    row[f"ok_{gname}"] = good
                    failed += [] if good else [(gname, shape, name, p)]
                    if shape == TRAIN_SHAPE and name == "bfloat16" and p > 0:
                        key = "flash_bwd_dq" if gname == "dq" else "flash_bwd_dkv"
                        errs[key] = max(errs.get(key, 0.0),
                                        row[f"max_abs_err_{gname}"])
                # a fully masked batch row gets zero gradient
                row["masked_row_grad_zero"] = all(
                    bool((g[-1] == 0).all()) for g in got)
                if name == "bfloat16":
                    row.update(_bwd_bf16_checks(att, q, k, v, mask, o, lse, do,
                                                p, seed + 17, got))
                    failed += [] if row["dk_dv_bit_equal_on_rerun"] else [
                        ("bwd_determinism", shape, p)]
                    failed += [] if row["ok_prep"] and row["ok_post"] else [
                        ("bwd_prep_post", shape, p)]
                    if shape == TRAIN_SHAPE and p > 0:
                        errs["flash_bwd"] = max(row["max_abs_err_dq"],
                                                row["max_abs_err_dk"],
                                                row["max_abs_err_dv"])
                        errs["flash_bwd_prep"] = row["max_abs_err_delta"]
                        errs["flash_bwd_post"] = row["max_abs_err_post"]
                emit(row)
                if not row["masked_row_grad_zero"]:
                    failed.append(("masked_row", shape, name, p))
                if shape == TRAIN_SHAPE and name == "bfloat16" and p > 0:
                    errs["flash_fwd"] = max(_max_err(o, o_ref),
                                            _max_err(lse, lse_ref))
    failed += _gelu_check(seed, errs)
    failed += _layer_norm_check(seed, errs)
    if failed:
        raise AssertionError(f"kernels disagree with the plain versions: "
                             f"{failed}")


# The bf16 backward's pre-pass against `attention_delta`: f32 sums of the
# same products in another order, |err| <= 1e-5 * (1 + |delta|); lse2 is
# the same f32 product in both (relative 1e-6 allows for the rounding of
# log2(e) to f32 in one of them). The post-pass: the same f32 product and
# bf16 rounding in both, so bit-equal.
PREP_TOLERANCE = 1e-5


def _bwd_bf16_checks(att, q, k, v, mask, o, lse, do, p, seed, got):
    """The bf16 backward's pre-pass and post-pass against their plain
    versions, and a rerun on equal inputs: dk and dv must be bit-equal (a
    fixed order of sums); dq may differ at f32 rounding before its bf16
    cast (the order of the reduce-adds into its accumulator varies), so its
    largest difference is reported."""
    import torch
    delta, lse2, acc = att.flash_bwd_prep(o, do, lse)
    want_delta, want_lse2, _ = att.attention_bwd_prep_reference(o, do, lse)
    err_delta = (delta - want_delta).abs()
    ok_prep = (bool((err_delta <= PREP_TOLERANCE * (1 + want_delta.abs())).all())
               and bool(torch.isclose(lse2, want_lse2, rtol=1e-6, atol=0).all())
               and not bool(acc.any()))
    acc.normal_()
    dq = att.flash_bwd_post(acc, q)
    want_dq = att.attention_bwd_post_reference(acc, q)
    again = att.flash_attention_bwd(q, k, v, mask, o, lse, do, p, seed)
    return {"max_abs_err_delta": err_delta.max().item(), "ok_prep": ok_prep,
            "max_abs_err_post": _max_err(dq, want_dq),
            "ok_post": torch.equal(dq, want_dq),
            "dk_dv_bit_equal_on_rerun": (torch.equal(again[1], got[1])
                                         and torch.equal(again[2], got[2])),
            "dq_rerun_max_abs_diff": _max_err(again[0], got[0])}


def _layer_norm_check(seed: int, errs: dict):
    """The LayerNorm kernels against autograd of the plain version."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    failed = []
    for rows, n, mean in LN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cpu").manual_seed(seed)
            x = (torch.randn(rows, n, generator=gen) + mean).to("cuda", dtype)
            dy = torch.randn(rows, n, generator=gen).to("cuda", dtype)
            w = (1 + 0.1 * torch.randn(n, generator=gen)).cuda()
            b = (0.1 * torch.randn(n, generator=gen)).cuda()
            y = ln.layer_norm_fwd(x, w, b, 1e-5)
            dx, dw, db = ln.layer_norm_bwd(x, dy, w, 1e-5)
            xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, w, b))
            yr = ln.layer_norm_reference(xr, wr, br, 1e-5, dtype)
            yr.backward(dy)
            atol, rtol = LN_TOLERANCE[name]
            row = {"phase": "kernel_check", "kernel": "layer_norm",
                   "shape": [rows, n], "mean": mean, "dtype": name,
                   "atol": atol, "rtol": rtol}
            for kname, got, want in (("y", y, yr), ("dx", dx, xr.grad),
                                     ("dw", dw, wr.grad), ("db", db, br.grad)):
                want = want.detach().float()
                err = (got.float() - want).abs()
                lim = atol * (want.abs().max().item() if kname in ("dw", "db")
                              else 1.0)
                ok = bool((err <= lim + rtol * want.abs()).all())
                row[f"max_abs_err_{kname}"] = err.max().item()
                row[f"ok_{kname}"] = ok
                failed += [] if ok else [(f"layer_norm_{kname}", rows, name)]
            emit(row)
            if rows == LN_SHAPES[1][0] and mean == 0.0 and name == "bfloat16":
                errs["layer_norm_fwd"] = row["max_abs_err_y"]
                errs["layer_norm_bwd"] = row["max_abs_err_dx"]
    return failed


def _gelu_check(seed: int, errs: dict):
    """The GELU kernels against their plain versions on inputs spanning
    the clip range and its tails."""
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
                if shape == GELU_SHAPES[1] and name == "bfloat16":
                    errs[f"gelu_logit_erf_{kname}"] = err.max().item()
            emit(row)
    return failed


def phase_bits_check(seed: int, errs: dict):
    """Both dump orders equal to each other and to the plain bits; keep rate
    at S = 1024; the dumped-bits check of tools/verify_dropout_bits."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.tools import verify_dropout_bits
    b, h, s, _ = TRAIN_SHAPE
    for bs, hs, ss in ((b, h, s), (1, 1, 1024), (2, 3, 256)):
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
        errs["keep_bits_dump" if ss == s else "keep_bits_dump@verify"] = float(mism)
    res = verify_dropout_bits.verify(device="cuda")
    emit({"phase": "bits_check", "verify_dropout_bits": res})


def phase_timing(seed: int):
    """Kernels, plain versions and library yardsticks at the train shape
    (bf16, dropout 0.1; the forward also at the eval shape, no dropout)."""
    import torch
    import torch.nn.functional as F
    from multimodal_sequencing_tpu_torch.ops import attention as att
    rows = {}

    def inputs(shape, lo):
        q, k, v, _ = make_attention_inputs(shape, torch.bfloat16, seed)
        b, _, s, _ = shape
        # packed stories fill most of S: keep lo..S keys per row
        gen = torch.Generator(device="cpu").manual_seed(seed + 1)
        lengths = torch.randint(lo, s + 1, (b,), generator=gen)
        mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32)
        return q, k, v, mask.cuda()

    b, h, s, d = EVAL_SHAPE
    q, k, v, mask = inputs(EVAL_SHAPE, 260)
    bool_mask = mask.bool()[:, None, None, :]
    bhsd = b * h * s * d
    emit({"phase": "timing", "kernel": "flash_fwd", "shape_bhsd": list(EVAL_SHAPE),
          "dropout_p": 0.0,
          "ms": kernel_ms(lambda: att.flash_attention(q, k, v, mask)),
          "plain_ms": kernel_ms(lambda: att.attention_reference_lse(q, k, v, mask)),
          "library_ms": kernel_ms(lambda: F.scaled_dot_product_attention(
              q, k, v, attn_mask=bool_mask)),
          **bound(4 * bhsd * 2 + b * h * s * 4 + b * s * 4, 4 * b * h * s * s * d)})

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
    rows["flash_fwd"] = {
        "ms": kernel_ms(lambda: att.flash_attention(q, k, v, mask, DROPOUT_P, sd)),
        "plain_ms": kernel_ms(lambda: att.attention_reference_lse(
            q, k, v, mask, DROPOUT_P, sd), iters=10),
        "library_ms": kernel_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bool_mask, dropout_p=DROPOUT_P)),
        **bound(4 * bhsd * 2 + bhs * 4 + b * s * 4, 4 * b * h * s * s * d)}
    # the bf16 backward: the whole (pre-pass, main, post-pass) against its
    # bound and SDPA's backward; the main kernel, which yields dq's partials
    # and dk, dv in one pass, stands for both TPU kernels it replaces
    s_pad = -(-s // 64) * 64
    acc_bytes = b * h * s_pad * d * 4
    prep, lse2_b, acc = att.flash_bwd_prep(o, do, lse)
    bwd_ms = kernel_ms(lambda: att.flash_attention_bwd(
        q, k, v, mask, o, lse, do, DROPOUT_P, sd))
    main_ms = kernel_ms(lambda: att.flash_bwd_main(
        q, k, v, mask, lse2_b, prep, acc, do, DROPOUT_P, sd))
    rows["flash_bwd"] = {
        "ms": bwd_ms, "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms,
        "library_ratio": bwd_ms / lib_bwd_ms,
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

    for name, (bs, hs, ss) in (("keep_bits_dump", (b, h, s)),
                               ("keep_bits_dump@verify", (2, 3, 256))):
        rows[name] = {
            "ms": kernel_ms(lambda: dump_pair(bs, hs, ss)),
            "plain_ms": kernel_ms(lambda: att.keep_bits(
                sd, bs, hs, ss, DROPOUT_P, "cuda"), iters=10),
            "library_ms": None,
            **bound(2 * bs * hs * ss * ss, 0)}
    from multimodal_sequencing_tpu_torch.ops import gelu as gl
    x = torch.randn(GELU_SHAPES[1], generator=gen).to("cuda", torch.bfloat16) * 3
    g = torch.randn(GELU_SHAPES[1], generator=gen).to("cuda", torch.bfloat16)
    nbytes = x.numel() * 2
    rows["gelu_logit_erf_fwd"] = {
        "ms": kernel_ms(lambda: gl.gelu_logit_erf_fwd(x)),
        "plain_ms": kernel_ms(lambda: gl.gelu_logit_erf_reference(x), iters=10),
        "library_ms": kernel_ms(lambda: F.gelu(x)), **bound(2 * nbytes, 0)}
    rows["gelu_logit_erf_bwd"] = {
        "ms": kernel_ms(lambda: gl.gelu_logit_erf_bwd(x, g)),
        "plain_ms": kernel_ms(lambda: gl.gelu_logit_erf_bwd_reference(x, g),
                            iters=10),
        "library_ms": kernel_ms(lambda: torch.ops.aten.gelu_backward(g, x)),
        **bound(3 * nbytes, 0)}
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    x = torch.randn(b * s, 1024, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(b * s, 1024, generator=gen).to("cuda", torch.bfloat16)
    w = torch.ones(1024, device="cuda")
    bias = torch.zeros(1024, device="cuda")
    xr = x.detach().clone().requires_grad_()
    yr = torch.nn.functional.layer_norm(xr.float(), (1024,), w, bias).bfloat16()
    nbytes = x.numel() * 2
    rows["layer_norm_fwd"] = {
        "ms": kernel_ms(lambda: ln.layer_norm_fwd(x, w, bias, 1e-5)),
        "plain_ms": kernel_ms(lambda: ln.layer_norm_reference(
            x, w, bias, 1e-5, torch.bfloat16)),
        "library_ms": kernel_ms(lambda: torch.nn.functional.layer_norm(
            x, (1024,), w.bfloat16(), bias.bfloat16())),
        **bound(2 * nbytes + 2 * 1024 * 4, 0)}

    def plain_bwd():
        xp = x.detach().requires_grad_()
        wp, bp = w.detach().requires_grad_(), bias.detach().requires_grad_()
        ln.layer_norm_reference(xp, wp, bp, 1e-5, torch.bfloat16).backward(dy)

    rows["layer_norm_bwd"] = {
        "ms": kernel_ms(lambda: ln.layer_norm_bwd(x, dy, w, 1e-5)),
        "plain_ms": kernel_ms(plain_bwd),
        "library_ms": kernel_ms(lambda: torch.autograd.grad(
            yr, xr, dy, retain_graph=True)),
        **bound(3 * nbytes + 3 * 1024 * 4, 0)}
    for name, row in rows.items():
        emit({"phase": "timing", "kernel": name, **row})
    return rows


def write_wikihow(root: str, split: str, n_stories: int, seed: int) -> None:
    """A WikiHow-schema split of 5-step stories whose steps fill
    `per_seq_max_length` = 60 tokens, so a packed story is ~300 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, f"wikihow-{split}.json"), "w") as f:
        for a in range(n_stories):
            steps = []
            for s in range(5):
                words = rng.choice(WORDS, size=70).tolist()
                steps.append({
                    "step_headline": f"Step {s}",
                    "step_text": {"text": f"Story {a} step {s}. " + " ".join(words),
                                  "bullet_points": []},
                    "step_assets": {}})
            f.write(json.dumps({
                "url": f"https://wikihow.test/{split}/{a}", "title": f"Story {a}",
                "summary": "", "sections": [{"steps": steps}]}) + "\n")


def _eval_argv(data_dir, out_dir, seed, *extra):
    return ["--model_name_or_path", "simple", "--model_size", "large",
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
            and all(counts[k] == batches * PER_FORWARD.get(k, NUM_LAYERS)
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
          and all(counts[k] == TRAIN_STEPS * PER_FORWARD.get(k, NUM_LAYERS)
                  for k in PATH_KERNELS["train"])
          and all(counts[k] == 0 for k in F32_BWD)
          and os.path.isfile(os.path.join(ckpt, "model.pt")))
    if not ok:
        raise AssertionError(f"train path check failed: {summary}")
    ev_dir = os.path.join(work, "train_eval")
    results, evaluator = run_eval(_eval_argv(
        data_dir, ev_dir, seed, "--model_name_or_path_1", ckpt))
    perms = _check_eval_outputs(ev_dir, 16)
    emit({"phase": "train_path", "eval_of_checkpoint": results["test"],
          "forwards": evaluator.forwards, "all_permutations": perms})
    if not perms:
        raise AssertionError("eval of the trained checkpoint failed")
    return counts


KERNEL_CLASSES = (("flash_fwd", ("flash_fwd",)),
                  ("flash_bwd", ("flash_bwd_",)),
                  ("gelu_logit_erf", ("gelu_fwd", "gelu_bwd")),
                  ("layer_norm", ("layer_norm_fwd", "layer_norm_bwd")),
                  ("matmul", ("gemm", "sm90_", "cutlass", "xmma", "cublas",
                              "nvjet")),
                  ("optimizer (foreach)", ("foreach", "multi_tensor")),
                  ("reduce", ("reduce",)),
                  ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _by_class(prof, wall_ms):
    import torch
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["other"] = 0.0
    kernels = []
    for evt in prof.key_averages():
        # kernel events only: a CPU op's device time repeats its kernels'
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        key = evt.key.lower()
        cls = next((name for name, pats in KERNEL_CLASSES
                    if any(p in key for p in pats)), "other")
        by_class[cls] += ms
        kernels.append((ms, evt.count, evt.key[:80]))
    busy = sum(by_class.values())
    return {"device_ms_by_class": by_class, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
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


PHASES = ("kernel_check", "bits_check", "timing", "main_path", "breakdown",
          "reference", "train_path", "train_breakdown", "train_reference")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_sequencing_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
            "reference": lambda: phase_reference(args.seed),
            "train_path": lambda: launches.update(train=phase_train_path(args.seed, work)),
            "train_breakdown": lambda: phase_train_breakdown(args.seed),
            "train_reference": lambda: phase_train_reference(args.seed),
        }
        for name in args.phases:
            t0 = time.perf_counter()
            try:
                run[name]()
            except Exception as e:  # report every phase, then fail
                traceback.print_exc()
                emit({"phase": name, "ok": False, "error": repr(e)})
                failed.append(name)
            emit({"phase": name, "seconds": time.perf_counter() - t0})
    for path, names in PATH_KERNELS.items():
        if path in launches and any(launches[path][k] == 0 for k in names):
            failed.append(f"{path} path launched a kernel of its path no time")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        counter = COUNTER.get(name, name)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": errs.get(name),
               "launches": launches.get("train", {}).get(counter, 0)}
        row.update({k: timing.get(name, {}).get(k) for k in
                    ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        out = {k: row.get(k) for k in order}
        out["launches_by_path"] = {p: c.get(counter, 0)
                                   for p, c in launches.items()}
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
