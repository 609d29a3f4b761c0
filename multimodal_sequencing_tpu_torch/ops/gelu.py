"""GELU for the encoder MLP (counterpart of `ops/gelu.py`).

The JAX package offers four implementations. Three of them compute erf
GELU: "erf" (XLA's erf), and "logit_erf" (the JAX default) and "fast_erf",
two cheaper forms whose bf16 outputs the JAX package verified exhaustively
to be within 1 bf16 ulp of "erf" (`ops/gelu.py:20-32` there). Here all
three run as PyTorch's exact erf GELU, so the port's default agrees with
the JAX default to within that ulp in bf16. "tanh" is the tanh
approximation (HF `gelu_new`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ERF_IMPLS = ("erf", "logit_erf", "fast_erf")


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """Dispatch by EncoderConfig.gelu_impl."""
    if impl in _ERF_IMPLS:
        return F.gelu(x)
    if impl == "tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown gelu impl {impl!r}")
