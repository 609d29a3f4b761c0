"""Host time per call of the port's flash-attention forward, LayerNorm
forward and backward and logit_erf GELU wrappers, on one NVIDIA card.

    python multimodal_sequencing_tpu_torch/tools/host_cost.py [--root DIR]
        [--calls NAME ...]

Imports `multimodal_sequencing_tpu_torch` from DIR (default: the checkout
this file is in), so that one copy of the script times two trees of the
package, such as a commit and its parent, on the same card; run them in
turn (parent, change, change, parent) and compare within one machine. Each
run builds the kernels it calls into its tree's build directory; `--calls`
times a subset (and builds only their kernels).
Prints one JSON line: the card's name and power limit, and for each call
the mean host microseconds of one call over `--iters` calls issued while
the card spins (so that no call waits for the card), once per repeat.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the train and eval shapes of the RoBERTa-large sequencer (chip_smoke.py)
EVAL_BHSD, TRAIN_BHSD, LN_ROWS = (32, 16, 320, 64), (8, 16, 320, 64), 8 * 320
GELU_SHAPE = (8 * 320, 4096)  # the train MLP activation


def host_us(fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean host time of one call in microseconds: `iters` calls issued back
    to back while the card spins, so that no call waits for the card."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # clock cycles, longer than the calls
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / iters * 1e6


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--calls", nargs="+", default=None,
                    help="names of the calls to time (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_sequencing_tpu_torch.ops import attention as att
    from multimodal_sequencing_tpu_torch.ops import gelu as gl
    from multimodal_sequencing_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device="cpu").manual_seed(0)

    def heads(shape):  # the encoder's head-split view of (B, S, H*D)
        b, h, s, d = shape
        return torch.randn((b, s, h, d), generator=gen).to(
            "cuda", torch.bfloat16).transpose(1, 2)

    calls = {}
    for name, shape, p in (("flash_attention@eval", EVAL_BHSD, 0.0),
                           ("flash_attention@train", TRAIN_BHSD, 0.1)):
        q, k, v = (heads(shape) for _ in range(3))
        mask = torch.ones(shape[0], shape[2], dtype=torch.int32, device="cuda")
        calls[name] = (lambda q=q, k=k, v=v, mask=mask, p=p:
                       att.flash_attention(q, k, v, mask, p, 5))
    x, dy = (torch.randn(LN_ROWS, 1024, generator=gen).to("cuda", torch.bfloat16)
             for _ in range(2))
    w, b = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
    calls["layer_norm_fwd"] = lambda: ln.layer_norm_fwd(x, w, b, 1e-5)
    calls["layer_norm_bwd"] = lambda: ln.layer_norm_bwd(x, dy, w, 1e-5)
    a, g = (torch.randn(GELU_SHAPE, generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    calls["gelu_logit_erf_fwd"] = lambda: gl.gelu_logit_erf_fwd(a)
    calls["gelu_logit_erf_bwd"] = lambda: gl.gelu_logit_erf_bwd(a, g)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    out = {"root": os.path.abspath(args.root), "card": card,
           "iters": args.iters, "host_us_per_call": {}}
    for name, fn in calls.items():
        if args.calls and name not in args.calls:
            continue
        out["host_us_per_call"][name] = [host_us(fn, args.iters)
                                         for _ in range(args.repeats)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
