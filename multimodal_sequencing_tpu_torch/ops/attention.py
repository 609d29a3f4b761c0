"""Multi-head attention: the hand-written Hopper flash kernels and their
plain versions (counterpart of `ops/attention.py`).

  * `_mix32`, `_keep_bits`, `_seed_for_bh` — the murmur3 counter keep bits
    of the HF "probs" dropout, bit for bit as the JAX package's, in 32-bit
    wrapping arithmetic carried in int64 tensors. `csrc/keep_bits.cuh`
    computes the same function on the card.
  * `attention_reference_lse` / `attention_reference` — plain PyTorch
    forward: f32 logits, key mask applied by `where` (masked keys score
    `NEG_INF`), softmax, optional dropout of the probabilities by the keep
    bits, probabilities cast to the input dtype before the product with V.
  * `attention_bwd_reference` — the plain backward, written out as the dq
    and dk/dv kernels compute it (not autograd of the forward): a key the
    mask drops gets p = 0, so a fully masked row gets zero gradient although
    the forward makes it uniform.
  * `flash_attention` (`csrc/flash_fwd.cu`), `flash_attention_bwd_dq` and
    `flash_attention_bwd_dkv` (`csrc/flash_bwd.cu`), `dump_keep_bits`
    (`csrc/keep_bits_dump.cu`) — wrappers that launch the kernels for CUDA
    tensors (or raise) and take the plain versions for CPU tensors. Each
    counts its kernel launches in `.launches`.
  * `FlashAttention` — the differentiable entry (`_flash_attention_ad`);
    `multihead_attention` — the encoder's entry.

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
from ._build import DTYPE_CODE

NEG_INF = -1e9  # matches the JAX package's additive masks

_HEAD_DIMS = (16, 32, 64)
_M32 = 0xFFFFFFFF


# ----- keep bits ----------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return ((((hi * c) & 0xFFFF) << 16) + lo * c) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64 (logical shifts,
    wrapping multiplies)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _keep_bits(seed_bh: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               seq_len: int, thresh: int) -> torch.Tensor:
    """(..., len(rows), len(cols)) bool keep mask; deterministic in
    (seed_bh, absolute row, absolute col). `seed_bh` broadcasts against the
    trailing (rows, cols) dims."""
    idx = (rows[:, None] * seq_len + cols[None, :]) & _M32
    x = _mix32((_mul32(idx, 0x9E3779B9) + seed_bh) & _M32)
    return (x & 0x7FFFFFFF) < thresh


def _seed_for_bh(seed: int, bh: torch.Tensor) -> torch.Tensor:
    """Per batch*head seed: decorrelates the rows of large batches."""
    return _mix32((seed + _mul32((bh + 1) & _M32, 668265263)) & _M32)


def keep_threshold(dropout_p: float) -> int:
    """The keep threshold on the 31-bit hash, computed on the host."""
    return int((1.0 - dropout_p) * 2147483647)


def keep_bits(seed: int, b: int, h: int, s: int, dropout_p: float,
              device="cpu") -> torch.Tensor:
    """Plain keep bits of every (batch, head, row, col): (B, H, S, S) bool."""
    ar = torch.arange(s, dtype=torch.int64, device=device)
    bh = torch.arange(b * h, dtype=torch.int64, device=device)
    seeds = _seed_for_bh(seed, bh)[:, None, None]
    return _keep_bits(seeds, ar, ar, s, keep_threshold(dropout_p)).view(
        b, h, s, s)


# ----- plain versions -----------------------------------------------------


def _key_keep(mask, b, s, device):
    if mask is None:
        return torch.ones((b, 1, 1, s), dtype=torch.bool, device=device)
    return mask.bool()[:, None, None, :]


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            dropout_p: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel. q, k, v: (B, H, S, D); mask:
    (B, S) key keep-mask. Returns (o (B, H, S, D) in the input dtype, lse
    (B*H, S) f32). With dropout_p > 0 the probabilities are dropped by the
    keep bits of `seed` and rescaled by 1 / (1 - dropout_p); lse stays that
    of the undropped softmax."""
    b, h, s, d = q.shape
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    logits = logits.masked_fill(~_key_keep(mask, b, s, q.device), NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        bits = keep_bits(seed, b, h, s, dropout_p, q.device)
        probs = torch.where(bits, probs / (1.0 - dropout_p), 0.0)
    o = torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)
    return o, lse.reshape(b * h, s)


def attention_reference(q, k, v, mask=None, dropout_p=0.0, seed=0):
    """Plain attention context, (B, H, S, D)."""
    return attention_reference_lse(q, k, v, mask, dropout_p, seed)[0]


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, from O as stored: (B*H, S)."""
    b, h, s, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * h, s)


def attention_bwd_reference(q, k, v, mask, o, lse, do, dropout_p: float = 0.0,
                            seed: int = 0):
    """Plain version of the backward kernels: (dq, dk, dv), each (B, H, S, D)
    in the input dtype. p = where(key kept, exp(s - lse), 0), dp = dO V^T
    dropped by the same bits, ds = p (dp - delta), dq = scale ds K,
    dk = scale ds^T Q, dv = (dropped p)^T dO."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = attention_delta(o, do).view(b, h, s, 1)
    sc = scale * torch.einsum("bhsd,bhtd->bhst", qf, kf)
    p = torch.where(_key_keep(mask, b, s, q.device),
                    torch.exp(sc - lse.view(b, h, s, 1)), 0.0)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    p_ctx = p
    if dropout_p > 0.0:
        bits = keep_bits(seed, b, h, s, dropout_p, q.device)
        dp = torch.where(bits, dp / (1.0 - dropout_p), 0.0)
        p_ctx = torch.where(bits, p / (1.0 - dropout_p), 0.0)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhst,bhtd->bhsd", ds, kf)
    dk = scale * torch.einsum("bhst,bhsd->bhtd", ds, qf)
    dv = torch.einsum("bhst,bhsd->bhtd", p_ctx, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----- kernel wrappers ----------------------------------------------------


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # dtype, head_dim, q, k, v, mask, o, lse, B, H, S, strides, scale,
    # seed, thresh, inv_keep, stream
    ("flash_fwd", "flash_fwd"): [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _STRIDES, _F, _U, _U, _F, _P],
    # dtype, head_dim, q, k, v, do, mask, lse, delta, dq, B, H, S, strides,
    # scale, seed, thresh, inv_keep, stream
    ("flash_bwd", "flash_bwd_dq"): [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _STRIDES, _F, _U, _U, _F, _P],
    # ..., dk, dv, ...
    ("flash_bwd", "flash_bwd_dkv"): [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _I, _I, _STRIDES, _F, _U, _U, _F,
                                     _P],
    # order, out, B*H, S, seed, thresh, stream
    ("keep_bits_dump", "keep_bits_dump"): [_I, _P, _I, _I, _U, _U, _P],
}


def _fn(lib_name: str, fn_name: str):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[(lib_name, fn_name)]
        fn.restype = _I
    return fn


def _dropout_args(dropout_p: float, seed: int):
    """(seed as uint32, keep threshold, 1 / keep) for the kernels; a
    threshold of 0 turns dropout off."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p == 0.0:
        return 0, 0, 1.0
    return seed & _M32, keep_threshold(dropout_p), 1.0 / (1.0 - dropout_p)


def _check_qkv(name, tensors, mask):
    q = tensors[0]
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{name}: tensors must share one (B, H, S, D) shape, "
                         f"got {[tuple(x.shape) for x in tensors]}")
    if q.dtype not in DTYPE_CODE or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors, got "
                        f"{[x.dtype for x in tensors]}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{name}: tensors must be on one device")
    b, h = q.shape[:2]
    if b * h > 65535:
        raise ValueError(f"{name} takes at most 65535 batch*heads, got {b * h}")
    for x in tensors:
        # rows are read as 16-byte vectors
        if (x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous head dim, row strides "
                             f"that are multiples of 8 elements and 16-byte "
                             f"aligned data")
    if mask is not None and (tuple(mask.shape) != (b, q.shape[2])
                             or mask.device != q.device):
        raise ValueError(f"mask must be (B, S) = {(b, q.shape[2])} on "
                         f"{q.device}, got {tuple(mask.shape)} on "
                         f"{mask.device}")


def _check(q, k, v, mask):
    _check_qkv("flash_fwd", (q, k, v), mask)


def _on_cuda(name, x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _mask_i32(mask, b, s, device):
    if mask is None:
        return torch.ones((b, s), dtype=torch.int32, device=device)
    return mask.to(torch.int32).contiguous()


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *[x.stride(i) for x in tensors for i in range(3)])


_CPU_BWD = ("the backward kernels take CUDA tensors; CPU tensors go through "
            "flash_attention_bwd's plain version")


def _bshd(like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) tensor laid out (B, S, H, D) in memory, so
    merging the heads back is a view."""
    b, h, s, d = like.shape
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (o (B, H, S, D), lse (B*H, S) f32).

    q, k, v: (B, H, S, D), any S, head dim 16, 32 or 64, float32 or
    bfloat16; the head dim must be contiguous (a head-split view of a
    (B, S, H*D) projection is taken as is). mask: (B, S) key keep-mask.
    dropout_p > 0 drops the probabilities by the keep bits of `seed`
    (int32). The returned o is laid out (B, S, H, D) in memory.
    `flash_attention.launches` counts kernel launches."""
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    if not _on_cuda("flash_attention", q):
        return attention_reference_lse(q, k, v, mask, dropout_p, seed)
    _check(q, k, v, mask)
    b, h, s, d = q.shape
    mask = _mask_i32(mask, b, s, q.device)
    o = _bshd(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    rc = _fn("flash_fwd", "flash_fwd")(
        DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, s,
        _strides(q, k, v, o), 1.0 / math.sqrt(d), seed_u, thresh, inv_keep,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed (code {rc})")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def flash_attention_bwd_dq(q, k, v, mask, lse, delta, do,
                           dropout_p: float = 0.0, seed: int = 0
                           ) -> torch.Tensor:
    """dq of the flash backward (`_flash_bwd_dq_kernel`), (B, H, S, D) laid
    out (B, S, H, D). lse, delta: (B*H, S) f32. CUDA tensors only; the CPU
    takes `attention_bwd_reference` through `flash_attention_bwd`."""
    if not _on_cuda("flash_attention_bwd_dq", q):
        raise ValueError(_CPU_BWD)
    _check_qkv("flash_bwd_dq", (q, k, v, do), mask)
    b, h, s, d = q.shape
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    mask = _mask_i32(mask, b, s, q.device)
    dq = _bshd(q)
    rc = _fn("flash_bwd", "flash_bwd_dq")(
        DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, h, s, _strides(q, k, v, do, dq),
        1.0 / math.sqrt(d), seed_u, thresh, inv_keep,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed (code {rc})")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                            dropout_p: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the flash backward (`_flash_bwd_dkv_kernel`), each
    (B, H, S, D) laid out (B, S, H, D). CUDA tensors only."""
    if not _on_cuda("flash_attention_bwd_dkv", q):
        raise ValueError(_CPU_BWD)
    _check_qkv("flash_bwd_dkv", (q, k, v, do), mask)
    b, h, s, d = q.shape
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    mask = _mask_i32(mask, b, s, q.device)
    dk, dv = _bshd(k), _bshd(v)
    rc = _fn("flash_bwd", "flash_bwd_dkv")(
        DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, s,
        _strides(q, k, v, do, dk, dv), 1.0 / math.sqrt(d), seed_u, thresh,
        inv_keep, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed (code {rc})")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, mask, o, lse, do, dropout_p: float = 0.0,
                        seed: int = 0):
    """Flash backward (`flash_attention_bwd`): (dq, dk, dv) from the saved
    forward output `o` and lse. For CUDA tensors delta = rowsum(dO * O) is
    one PyTorch reduction, then the dq and the dk/dv kernels run; CPU
    tensors take `attention_bwd_reference`."""
    if not _on_cuda("flash_attention_bwd", q):
        return attention_bwd_reference(q, k, v, mask, o, lse, do, dropout_p,
                                       seed)
    if do.stride(-1) != 1 or any(st % 8 for st in do.stride()[:3]):
        do = do.contiguous()
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, dropout_p, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, dropout_p,
                                     seed)
    return dq, dk, dv


_DUMP_ORDERS = {"fwd": 0, "dkv": 1}


def dump_keep_bits(order: str, seed: int, b: int, h: int, s: int,
                   dropout_p: float, device="cuda") -> torch.Tensor:
    """The keep bits the attention kernels regenerate, (B, H, S, S) bool,
    written by `csrc/keep_bits_dump.cu` in the forward's tile order ("fwd":
    per 64-row q-tile, over the k-tiles) or the dk/dv kernel's ("dkv": per
    64-key tile, over the q-tiles). On the CPU both orders are the plain
    `keep_bits`."""
    if order not in _DUMP_ORDERS:
        raise ValueError(f"order must be one of {tuple(_DUMP_ORDERS)}")
    device = torch.device(device)
    if not _on_cuda("dump_keep_bits", torch.empty(0, device=device)):
        return keep_bits(seed, b, h, s, dropout_p, device)
    out = torch.empty((b, h, s, s), dtype=torch.bool, device=device)
    rc = _fn("keep_bits_dump", "keep_bits_dump")(
        _DUMP_ORDERS[order], out.data_ptr(), b * h, s, seed & _M32,
        keep_threshold(dropout_p),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"keep_bits_dump launch failed (code {rc})")
    dump_keep_bits.launches += 1
    return out


dump_keep_bits.launches = 0


# ----- differentiable entry -----------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (`_flash_attention_ad`): the forward
    saves q, k, v, mask, seed, O and lse; the backward launches the dq and
    dk/dv kernels, which regenerate the forward's keep bits from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed: int, dropout_p: float):
        o, lse = flash_attention(q, k, v, mask, dropout_p, seed)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.seed, ctx.dropout_p = seed, dropout_p
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, do,
                                         ctx.dropout_p, ctx.seed)
        return dq, dk, dv, None, None, None


def multihead_attention(q, k, v, mask=None, dropout_p: float = 0.0,
                        seed: Optional[int] = None):
    """Attention context (B, H, S, D): the flash kernels for CUDA tensors,
    the plain versions for CPU tensors. dropout_p > 0 (training, HF
    "probs" mode) needs an int32 `seed` for the keep bits."""
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout_p > 0 needs a seed")
    seed = 0 if seed is None else seed
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if mask is None:
            mask = torch.ones(q.shape[:1] + q.shape[2:3], dtype=torch.int32,
                              device=q.device)
        return FlashAttention.apply(q, k, v, mask, seed, dropout_p)
    return flash_attention(q, k, v, mask, dropout_p, seed)[0]
