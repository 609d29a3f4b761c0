"""Check that the attention kernels regenerate one dropout mask (counterpart
of the correctness half of `scripts/verify_hw_dropout_bits.py`).

    python -m multimodal_sequencing_tpu_torch.tools.verify_dropout_bits [--device cuda]

Dumps the keep bits in the forward's and in the dk/dv kernel's visit order
(`ops/attention.py::dump_keep_bits`), asserts the two dumps are equal, builds
the HF probs-dropout attention explicitly from the dumped bits (plain
PyTorch, autograd), and checks the fused forward and all three gradients of
`multihead_attention` against it, with a margin against the undropped
attention and the keep rate. Prints one JSON line; raises on a mismatch.
On `cuda` it runs the kernels; on `cpu` the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..ops.attention import NEG_INF, dump_keep_bits, multihead_attention

DROPOUT_P = 0.1
# f32 on both sides; the kernels sum in another order than the explicit
# einsums, and sin() of the sums passes their rounding to the gradients
O_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
KEEP_TOL = 0.005  # ~10 standard deviations of the keep rate at these sizes


def _explicit(q, k, v, mask, bits):
    """softmax -> where(bits, p / keep, 0) -> @ v, all f32, autograd."""
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, -1)
    if bits is not None:
        probs = torch.where(bits, probs / (1.0 - DROPOUT_P), 0.0)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


def verify(b: int = 2, h: int = 3, s: int = 256, d: int = 64,
           seed: int = 4242, device="cuda") -> dict:
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((b, h, s, d), generator=gen).to(device)
               .requires_grad_() for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[:, s - 17:] = 0
    mask = mask.to(device)

    bits = dump_keep_bits("fwd", seed, b, h, s, DROPOUT_P, device)
    if not torch.equal(bits, dump_keep_bits("dkv", seed, b, h, s, DROPOUT_P,
                                            device)):
        raise AssertionError("fwd and dkv orders dump different keep bits")

    o = multihead_attention(q, k, v, mask, DROPOUT_P, seed)
    got = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
    want_o = _explicit(q, k, v, mask, bits)
    want = torch.autograd.grad(torch.sin(want_o).sum(), (q, k, v))
    with torch.no_grad():
        nodrop_o = _explicit(q, k, v, mask, None)
    err_bits = (o - want_o).abs().max().item()
    err_nobits = (o - nodrop_o).abs().max().item()
    if not (err_bits <= O_ATOL and err_bits * 10 < err_nobits):
        raise AssertionError(f"forward vs the dumped-bits attention: "
                             f"{err_bits} (undropped: {err_nobits})")
    grad_err = {}
    for name, g, w in zip("qkv", got, want):
        grad_err[f"d{name}"] = (g - w).abs().max().item()
        if not bool(((g - w).abs() <= GRAD_ATOL + GRAD_RTOL * w.abs()).all()):
            raise AssertionError(f"d{name} vs the dumped-bits attention: "
                                 f"{grad_err[f'd{name}']}")
    keep = bits.float().mean().item()
    if abs(keep - (1.0 - DROPOUT_P)) > KEEP_TOL:
        raise AssertionError(f"keep rate {keep}")
    # several 64-row tiles each way, as in the script's multi-block check
    big = dump_keep_bits("fwd", seed, 1, 1, 1024, DROPOUT_P, device)
    if not torch.equal(big, dump_keep_bits("dkv", seed, 1, 1, 1024, DROPOUT_P,
                                           device)):
        raise AssertionError("fwd and dkv orders differ at S = 1024")
    keep_1024 = big.float().mean().item()
    if abs(keep_1024 - (1.0 - DROPOUT_P)) > KEEP_TOL:
        raise AssertionError(f"keep rate at S = 1024: {keep_1024}")
    return {"fwd_bwd_oracle": "ok", "bits_order_invariant": True,
            "keep_rate": keep, "keep_rate_s1024": keep_1024,
            "fwd_err_vs_bits": err_bits, "fwd_err_vs_nobits": err_nobits,
            "grad_err": grad_err, "device": str(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(verify(device=args.device)))


if __name__ == "__main__":
    main()
