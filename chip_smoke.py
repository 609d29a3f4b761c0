#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository. It builds the port's CUDA kernels from
the sources in the checkout, holds each kernel against its plain PyTorch
version on the card, times it, and drives the port's main path, the heat-map
sort evaluation (`trainers.eval --sort_method heat_map`) at the full
RoBERTa-large width, through `main_eval` on `cuda`. Every output line before
the last is one JSON object (plus the raw `nvidia-smi` line); the last line
is the contract line `{"ok": true, "device": {...}}`, printed only when
every phase passed. Without a CUDA device, or without the port's package
beside it, it exits non-zero and prints no result.
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
# 64-key tiles at S = 1024, and the tiny test config's head dim 16
KERNEL_SHAPES = [(32, 16, 320, 64), (4, 16, 566, 64), (2, 16, 1024, 64),
                 (2, 4, 40, 16)]
# Tolerance |got - want| <= atol + rtol * |want| for O, <= atol for lse. f32: the
# kernel and the plain version do the same f32 arithmetic in another order.
# bf16: both round the probabilities to bf16 before P.V and the output to
# bf16, so O may differ by one bf16 ulp (2^-7 relative at the bottom of a
# binade); lse is f32 in both.
TOLERANCE = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 1e-2)}
EVAL_SHAPE = KERNEL_SHAPES[0]
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
NUM_LAYERS = 24  # RoBERTa-large: one attention launch per layer per forward
N_STORIES = 40   # 5 eval batches of 8

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


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of one call on the card, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_kernel_check(seed: int):
    """Kernel against the plain version at every shape and dtype."""
    import torch
    from multimodal_sequencing_tpu_torch.ops import attention as att
    worst = 0.0
    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v, mask = make_attention_inputs(shape, dtype, seed)
            o, lse = att.flash_attention(q, k, v, mask)
            torch.cuda.synchronize()
            o_ref, lse_ref = att.attention_reference_lse(q, k, v, mask)
            atol, rtol = TOLERANCE[name]
            ok = all(bool(((got.float() - want.float()).abs()
                           <= atol + r * want.float().abs()).all())
                     for got, want, r in ((o, o_ref, rtol), (lse, lse_ref, 0.0)))
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            emit({"phase": "kernel_check", "kernel": "flash_fwd",
                  "shape_bhsd": list(shape), "dtype": name,
                  "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                  "atol": atol, "rtol": rtol, "ok": ok})
            if not ok:
                raise AssertionError(f"flash_fwd disagrees at {shape} {name}")
            if name == "bfloat16" and shape == EVAL_SHAPE:
                worst = max(err_o, err_lse)
    return worst


def phase_timing(seed: int):
    """Kernel, plain version and the library yardstick at the eval shape."""
    import torch
    import torch.nn.functional as F
    from multimodal_sequencing_tpu_torch.ops import attention as att
    b, h, s, d = EVAL_SHAPE
    q, k, v, _ = make_attention_inputs(EVAL_SHAPE, torch.bfloat16, seed)
    # packed stories fill most of S: keep 260..320 keys per row
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    lengths = torch.randint(260, s + 1, (b,), generator=gen)
    mask = (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).cuda()
    bool_mask = mask.bool()[:, None, None, :]
    kernel_ms = cuda_ms(lambda: att.flash_attention(q, k, v, mask))
    plain_ms = cuda_ms(lambda: att.attention_reference_lse(q, k, v, mask))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bool_mask))
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4 + b * s * 4
    flops = 4 * b * h * s * s * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    row = {"phase": "timing", "kernel": "flash_fwd",
           "shape_bhsd": list(EVAL_SHAPE), "dtype": "bfloat16",
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(row)
    return row


def write_wikihow(root: str, n_stories: int, seed: int) -> None:
    """A WikiHow-schema test split of 5-step stories whose steps fill
    `per_seq_max_length` = 60 tokens, so a packed story is ~300 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "wikihow-test.json"), "w") as f:
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
                "url": f"https://wikihow.test/{a}", "title": f"Story {a}",
                "summary": "", "sections": [{"steps": steps}]}) + "\n")


def phase_main_path(seed: int, n_stories: int, work: str):
    """The port's eval CLI at full RoBERTa-large width on the card."""
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.train.cli import run_eval
    from multimodal_sequencing_tpu_torch.train.evaluation import paper_result_line
    data_dir = os.path.join(work, "data")
    out_dir = os.path.join(work, "eval_out")
    os.makedirs(data_dir)
    write_wikihow(data_dir, n_stories, seed)
    argv = ["--model_name_or_path", "simple", "--model_size", "large",
            "--replace_token_type_embeddings", "--task_name", "wikihow_sort",
            "--hierarchical_version", "v1", "--sort_method", "heat_map",
            "--data_dir", data_dir, "--eval_splits", "test",
            "--max_seq_length", "320", "--per_seq_max_length", "60",
            "--per_gpu_eval_batch_size", "8", "--seed", str(seed),
            "--output_dir", out_dir, "--device", "cuda"]
    att.flash_attention.launches = 0
    t0 = time.perf_counter()
    results, evaluator = run_eval(argv)
    wall_s = time.perf_counter() - t0
    launches = att.flash_attention.launches
    batches = math.ceil(n_stories / 8)
    with open(os.path.join(out_dir, "output_order.txt")) as f:
        orders = [[int(x) for x in line.split()] for line in f]
    perms = all(sorted(o) == list(range(5)) for o in orders)
    headers, row = paper_result_line(results["test"])
    fwd, dec = evaluator.forward_seconds, evaluator.decode_seconds

    def median_after_first(xs):  # the first batch also warms the card up
        rest = sorted(xs[1:]) or xs
        return rest[len(rest) // 2]

    summary = {
        "phase": "main_path", "stories": n_stories, "batches": len(fwd),
        "forwards": evaluator.forwards, "flash_fwd_launches": launches,
        "launches_per_forward": launches / max(evaluator.forwards, 1),
        "all_permutations": perms, "orders": len(orders),
        "first_batch_s": fwd[0] + dec[0],
        "median_batch_s": median_after_first([f + d for f, d in zip(fwd, dec)]),
        "median_forward_s": median_after_first(fwd),
        "median_decode_s": median_after_first(dec),
        "wall_s_incl_init": wall_s, "metrics": results["test"],
        "paper_row": [headers, row]}
    emit(summary)
    print(headers, flush=True)
    print(row, flush=True)
    if not (evaluator.forwards == batches and launches == NUM_LAYERS * batches
            and perms and len(orders) == n_stories):
        raise AssertionError(f"main path check failed: {summary}")
    return launches


KERNEL_CLASSES = (("flash_fwd", ("flash_fwd",)),
                  ("matmul", ("gemm", "sm90_", "cutlass", "xmma", "cublas",
                              "nvjet")),
                  ("layer_norm", ("layer_norm", "layernorm")),
                  ("gelu", ("gelu",)))


def phase_breakdown(seed: int):
    """Device time of one warm eval forward (B = 32, S = 320, 24 layers,
    bf16) by kernel class, from torch.profiler, beside its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_sequencing_tpu_torch.models.config import (
        EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    b, _, s, _ = EVAL_SHAPE
    cfg = MultimodalConfig(encoder=EncoderConfig.roberta_large(type_vocab_size=5),
                           hierarchical_version="v1", max_seq_length=s)
    model = init_weights(SequencingModel(cfg), seed).to("cuda", torch.bfloat16).eval()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.randint(5, cfg.encoder.vocab_size, (b, s), generator=gen)
    ids[:, ::64] = cfg.cls_id
    types = (torch.arange(s) // 64).expand(b, s).contiguous()
    mask = torch.ones(b, s, dtype=torch.long)
    ids, types, mask = ids.cuda(), types.cuda(), mask.cuda()
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: model(ids, mask, types), iters=10)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(ids, mask, types)
            torch.cuda.synchronize()
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
    busy_ms = sum(by_class.values())
    emit({"phase": "breakdown", "shape_bs": [b, s], "forward_ms": forward_ms,
          "device_ms_by_class": by_class, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / forward_ms,
          "top_kernels": sorted(kernels, reverse=True)[:8]})


def phase_reference(seed: int):
    """The sequencer at full width, 2 layers, f32: card (kernel) against the
    CPU (plain version) on the same packed stories and weights."""
    import numpy as np
    import torch
    from multimodal_sequencing_tpu_torch.data.packing import StoryPacker
    from multimodal_sequencing_tpu_torch.data.tokenization import SimpleWordTokenizer
    from multimodal_sequencing_tpu_torch.models.config import (
        EncoderConfig, MultimodalConfig)
    from multimodal_sequencing_tpu_torch.models.sequencer import (
        SequencingModel, init_weights)
    tok = SimpleWordTokenizer()
    enc = EncoderConfig.roberta_large(vocab_size=len(tok), num_hidden_layers=2,
                                      type_vocab_size=5, dtype="float32")
    cfg = MultimodalConfig(encoder=enc, hierarchical_version="v1",
                           max_seq_length=320, per_seq_max_length=60)
    packer = StoryPacker(tok, 320, 60)
    rng = np.random.default_rng(seed)
    stories = [[" ".join(rng.choice(WORDS, size=int(rng.integers(10, 70))))
                for _ in range(int(rng.integers(3, 6)))] for _ in range(4)]
    packs = [packer.pack_story(t) for t in stories]
    ids, am, tt = (torch.from_numpy(np.stack([p[i] for p in packs])).long()
                   for i in range(3))
    model = init_weights(SequencingModel(cfg), seed).eval()
    with torch.inference_mode():
        want = model(ids, am, tt)
    model.cuda()
    with torch.inference_mode():
        got = model(ids.cuda(), am.cuda(), tt.cuda())
    err = {key: (got[key].float().cpu() - want[key].float()).abs().max().item()
           for key in ("heatmap", "step_reprs")}
    tol = 2e-4
    ok = (all(e <= tol for e in err.values())
          and torch.equal(got["present"].cpu(), want["present"]))
    emit({"phase": "reference", "layers": 2, "dtype": "float32",
          "max_abs_err": err, "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree on the 2-layer sequencer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "card": card, "kernels": list(_build.KERNELS),
          "build_s": build_s,
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling" in ln]})

    failed = []
    kernel = {"name": "flash_fwd", "route": "cuda",
              "source": "multimodal_sequencing_tpu_torch/ops/csrc/flash_fwd.cu",
              "replaces": "multimodal_sequencing_tpu/ops/attention.py:126"}
    with tempfile.TemporaryDirectory() as work:
        phases = [
            ("kernel_check", lambda: kernel.update(
                max_abs_err=phase_kernel_check(args.seed))),
            ("timing", lambda: kernel.update(
                {k: v for k, v in phase_timing(args.seed).items()
                 if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")})),
            ("main_path", lambda: kernel.update(
                launches=phase_main_path(args.seed, N_STORIES, work))),
            ("breakdown", lambda: phase_breakdown(args.seed)),
            ("reference", lambda: phase_reference(args.seed)),
        ]
        for name, run in phases:
            try:
                run()
            except Exception as e:  # report every phase, then fail
                traceback.print_exc()
                emit({"phase": name, "ok": False, "error": repr(e)})
                failed.append(name)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kernel.get(k) for k in order}]})
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
