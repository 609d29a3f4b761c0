"""Multi-head attention: the hand-written Hopper flash kernel and its plain
version (counterpart of `ops/attention.py`).

  * `attention_reference_lse` / `attention_reference` — plain PyTorch: f32
    logits, key mask applied by `where` (masked keys score `NEG_INF`),
    softmax, probabilities cast to the input dtype before the product with
    V. The CPU path and the oracle the kernel is held to.
  * `flash_attention` — wrapper around `csrc/flash_fwd.cu`, returning
    (o, lse). A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes the plain version.
  * `multihead_attention` — the encoder's entry: the context of
    `flash_attention`.

The `where` mask equals the JAX reference's additive `-1e9` bias whenever
|logit| < 32, where `logit - 1e9` rounds to `-1e9` in f32; either way a
row whose keys are all masked is uniform, not NaN.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e9  # matches the JAX package's additive masks

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel. q, k, v: (B, H, S, D); mask: (B, S)
    key keep-mask. Returns (o (B, H, S, D) in the input dtype, lse
    (B*H, S) f32)."""
    b, h, s, d = q.shape
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)
    return o, lse.reshape(b * h, s)


def attention_reference(q, k, v, mask=None):
    """Plain attention context, (B, H, S, D)."""
    return attention_reference_lse(q, k, v, mask)[0]


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [i, i, p, p, p, p, p, p, i, i, i,
                              ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_float, p]
    lib.flash_fwd.restype = i


def _check(q, k, v, mask):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head dims {_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, h = q.shape[:2]
    if b * h > 65535:
        raise ValueError(f"flash_fwd takes at most 65535 batch*heads, got "
                         f"{b * h}")
    for x in (q, k, v):
        # rows are read as 16-byte vectors
        if (x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError("flash_fwd needs a contiguous head dim, row "
                             "strides that are multiples of 8 elements and "
                             "16-byte aligned data")
    if mask is not None and (tuple(mask.shape) != (b, q.shape[2])
                             or mask.device != q.device):
        raise ValueError(f"mask must be (B, S) = {(b, q.shape[2])} on "
                         f"{q.device}, got {tuple(mask.shape)} on "
                         f"{mask.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (o (B, H, S, D), lse (B*H, S) f32).

    q, k, v: (B, H, S, D), any S, head dim 16, 32 or 64, float32 or
    bfloat16; the head dim must be contiguous (a head-split view of a
    (B, S, H*D) projection is taken as is). mask: (B, S) key keep-mask.
    The returned o is laid out (B, S, H, D) in memory, so merging the heads
    back is a view. `flash_attention.launches` counts kernel launches."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "dropout in the flash kernel comes with the training slice")
    if q.device.type == "cpu":
        return attention_reference_lse(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, mask)
    b, h, s, d = q.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.int32, device=q.device)
    mask = mask.to(torch.int32).contiguous()
    o = torch.empty((b, s, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        _declare(lib)
    strides = (ctypes.c_longlong * 12)(
        *[x.stride(i) for x in (q, k, v, o) for i in range(3)])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), mask.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), b, h, s, strides, 1.0 / math.sqrt(d),
                       stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed (code {rc})")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def multihead_attention(q, k, v, mask=None):
    """Attention context (B, H, S, D): the flash kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return flash_attention(q, k, v, mask)[0]
