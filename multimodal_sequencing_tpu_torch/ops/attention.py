"""Multi-head attention: the hand-written Hopper flash kernels and their
plain versions (counterpart of `ops/attention.py`).

  * `_mix32`, `_keep_bits`, `_seed_for_bh` — the murmur3 counter keep bits
    of the HF "probs" dropout, bit for bit as the JAX package's, in 32-bit
    wrapping arithmetic carried in int64 tensors. `csrc/keep_bits.cuh`
    computes the same function on the card. Each (batch, head) draws the
    bits of its global index: `index` = (b_off, h_off, h_tot) places a
    call's (B, H) heads in a larger batch and head count (a data- or
    tensor-parallel rank's slice of the step), local head h of row b
    drawing those of (b_off + b) * h_tot + h_off + h; the default (0, 0, H)
    is the call's own b * H + h.
  * `attention_reference_lse` / `attention_reference` — plain PyTorch
    forward: f32 logits, key mask applied by `where` (masked keys score
    `NEG_INF`), softmax, optional dropout of the probabilities by the keep
    bits, probabilities cast to the input dtype before the product with V.
  * `attention_bwd_reference` — the plain backward, written out as the dq
    and dk/dv kernels compute it (not autograd of the forward): a key the
    mask drops gets p = 0, so a fully masked row gets zero gradient although
    the forward makes it uniform.
  * `attention_delta`, `attention_bwd_prep_reference`,
    `attention_bwd_post_reference` — plain versions of the bf16 backward's
    pre-pass (delta = rowsum(dO * O), lse * log2(e), a zeroed dq
    accumulator) and post-pass (dq = scale * accumulator).
  * `kernel_width`, `with_kernel_width` — the kernels take head widths 16,
    32, 64 and 128; a call at another width up to 128 runs at the next of
    them on zero-padded tensors with the true width's scale, and its
    outputs are cut back (one pure function around the kernel call).
  * `bwd_turn`, `bwd_groups` — the bf16 main kernel's schedule (the order
    of its dq adds, and the accumulator slices a head needs), as
    `csrc/flash_bwd.cu` computes it.
  * `flash_attention` (`csrc/flash_fwd.cu`); `flash_bwd_prep`,
    `flash_bwd_main`, `flash_bwd_post` (the bf16 backward's three launches)
    and `flash_attention_bwd_dq`, `flash_attention_bwd_dkv` (the f32
    kernels) in `csrc/flash_bwd.cu`; `dump_keep_bits`
    (`csrc/keep_bits_dump.cu`) — wrappers that launch the kernels for CUDA
    tensors (or raise) and take the plain versions for CPU tensors. Each
    counts its kernel launches in `.launches`. Any batch*heads (the grids
    put them on x) and any S.
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

KERNEL_WIDTHS = (16, 32, 64, 128)  # the head widths the kernels are built for
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


def global_bh(b: int, h: int, index=None, device="cpu") -> torch.Tensor:
    """The global index of each of a call's (B, H) heads, (B*H,) int64:
    (b_off + b) * h_tot + h_off + h for `index` = (b_off, h_off, h_tot),
    b * H + h by default."""
    b_off, h_off, h_tot = index or (0, 0, h)
    rows = torch.arange(b, dtype=torch.int64, device=device) + b_off
    heads = torch.arange(h, dtype=torch.int64, device=device) + h_off
    return (rows[:, None] * h_tot + heads[None]).reshape(-1)


def keep_bits(seed: int, b: int, h: int, s: int, dropout_p: float,
              device="cpu", index=None) -> torch.Tensor:
    """Plain keep bits of every (batch, head, row, col): (B, H, S, S) bool,
    each head drawing those of its global index (`global_bh`)."""
    ar = torch.arange(s, dtype=torch.int64, device=device)
    bh = global_bh(b, h, index, device)
    seeds = _seed_for_bh(seed, bh)[:, None, None]
    return _keep_bits(seeds, ar, ar, s, keep_threshold(dropout_p)).view(
        b, h, s, s)


# ----- plain versions -----------------------------------------------------


def _key_keep(mask, b, s, device):
    if mask is None:
        return torch.ones((b, 1, 1, s), dtype=torch.bool, device=device)
    return mask.bool()[:, None, None, :]


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if scale is None else scale


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            dropout_p: float = 0.0, seed: int = 0,
                            index=None, scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel. q, k, v: (B, H, S, D); mask:
    (B, S) key keep-mask. Returns (o (B, H, S, D) in the input dtype, lse
    (B*H, S) f32). With dropout_p > 0 the probabilities are dropped by the
    keep bits of `seed` at the heads' global `index` and rescaled by
    1 / (1 - dropout_p); lse stays that of the undropped softmax. The
    logits' scale is 1 / sqrt(D) unless `scale` is given."""
    b, h, s, d = q.shape
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (
        _scale(d, scale))
    logits = logits.masked_fill(~_key_keep(mask, b, s, q.device), NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        bits = keep_bits(seed, b, h, s, dropout_p, q.device, index)
        probs = torch.where(bits, probs / (1.0 - dropout_p), 0.0)
    o = torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v)
    return o, lse.reshape(b * h, s)


def attention_reference(q, k, v, mask=None, dropout_p=0.0, seed=0,
                        index=None, scale=None):
    """Plain attention context, (B, H, S, D)."""
    return attention_reference_lse(q, k, v, mask, dropout_p, seed, index,
                                   scale)[0]


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, from O as stored: (B*H, S)."""
    b, h, s, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * h, s)


LOG2E = 1.4426950408889634


def _padded_len(s: int) -> int:
    """S rounded up to the bf16 backward's 64-row tiles."""
    return -(-s // 64) * 64


def attention_bwd_prep_reference(o: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor):
    """Plain version of the bf16 backward's pre-pass: (delta, lse2, acc).
    delta (B*H, S_pad) = rowsum(dO * O) in f32, 0 past S; lse2 (B*H, S_pad)
    = lse * log2(e), +inf past S; acc (B*H, S_pad, D) f32 zeros, the dq
    accumulator (one slice: `bwd_groups`). S_pad is S rounded up to a
    multiple of 64. (The kernel also zeroes the main kernel's turn
    counters, which have no plain counterpart.)"""
    b, h, s, d = o.shape
    pad = _padded_len(s) - s
    delta = torch.nn.functional.pad(attention_delta(o, do), (0, pad))
    lse2 = torch.nn.functional.pad(lse.float() * LOG2E, (0, pad),
                                   value=math.inf)
    acc = torch.zeros((b * h, s + pad, d), dtype=torch.float32,
                      device=o.device)
    return delta, lse2, acc


def _acc_chunk_order(s: int, d: int, device) -> torch.Tensor:
    """(S, D/4): where chunk c of dq row r sits in the accumulator's row.
    The main kernel stores its 16-byte chunks (4 f32) swizzled, c ^ (r & m)
    with m = min(8, D/4) - 1, so that its shared-memory stores of the
    partials are free of bank conflicts."""
    m = min(8, d // 4) - 1
    rows = torch.arange(s, device=device)[:, None]
    return torch.arange(d // 4, device=device)[None, :] ^ (rows & m)


def attention_bwd_post_reference(acc: torch.Tensor, like: torch.Tensor,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain version of the bf16 backward's post-pass: dq = scale * (the
    sum of acc's slices in slice order), (B, H, S, D) in `like`'s dtype,
    read through the accumulator's chunk order (`_acc_chunk_order`). acc:
    (B*H, groups * S_pad, W), slice g at rows [g * S_pad, (g + 1) * S_pad)
    of each head, W = D or the kernel width a D-wide call was padded to
    (`with_kernel_width`: its columns past D are cut)."""
    b, h, s, d = like.shape
    w = acc.shape[-1]
    s_pad = _padded_len(s)
    slices = acc.view(b * h, acc.shape[1] // s_pad, s_pad, w)
    total = slices[:, 0, :s]
    for g in range(1, slices.shape[1]):
        total = total + slices[:, g, :s]
    chunks = total.reshape(b * h, s, w // 4, 4)
    order = _acc_chunk_order(s, w, acc.device)[None, :, :, None]
    dq = torch.gather(chunks, 2, order.expand(b * h, s, w // 4, 4))
    dq = dq.reshape(b, h, s, w)[..., :d]
    return (dq * _scale(d, scale)).to(like.dtype)


def attention_bwd_reference(q, k, v, mask, o, lse, do, dropout_p: float = 0.0,
                            seed: int = 0, index=None, scale=None):
    """Plain version of the backward kernels: (dq, dk, dv), each (B, H, S, D)
    in the input dtype. p = where(key kept, exp(s - lse), 0), dp = dO V^T
    dropped by the same bits, ds = p (dp - delta), dq = scale ds K,
    dk = scale ds^T Q, dv = (dropped p)^T dO; scale 1 / sqrt(D) unless
    given."""
    b, h, s, d = q.shape
    scale = _scale(d, scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = attention_delta(o, do).view(b, h, s, 1)
    sc = scale * torch.einsum("bhsd,bhtd->bhst", qf, kf)
    p = torch.where(_key_keep(mask, b, s, q.device),
                    torch.exp(sc - lse.view(b, h, s, 1)), 0.0)
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    p_ctx = p
    if dropout_p > 0.0:
        bits = keep_bits(seed, b, h, s, dropout_p, q.device, index)
        dp = torch.where(bits, dp / (1.0 - dropout_p), 0.0)
        p_ctx = torch.where(bits, p / (1.0 - dropout_p), 0.0)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhst,bhtd->bhsd", ds, kf)
    dk = scale * torch.einsum("bhst,bhsd->bhtd", ds, qf)
    dv = torch.einsum("bhst,bhsd->bhtd", p_ctx, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----- head widths and the backward's schedule ---------------------------


def kernel_width(d: int) -> int:
    """The head width a width-d call runs at on the card: d itself for 16,
    32, 64 and 128, else the next of them. Raises past 128."""
    for w in KERNEL_WIDTHS:
        if d <= w:
            return w
    raise ValueError(f"the attention kernels take head widths up to "
                     f"{KERNEL_WIDTHS[-1]}, got {d}")


def _head_tensor(x, d: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() == 4 and x.shape[-1] == d


def with_kernel_width(fn, *args, **kwargs):
    """fn(*args, scale=1/sqrt(D), **kwargs) at the kernels' head width, D
    the last dim of args[0]: each (B, H, S, D) tensor of `args` zero-padded
    along its last dim to `kernel_width(D)`, each 4-d tensor that fn
    returns (alone or in a tuple) cut back to D. Zero columns leave q.k^T,
    and so the softmax and the keep bits (which depend on row, column and
    S only), unchanged, and give o, dq, dk and dv zero columns. At a kernel
    width the tensors go through as they are, with no copy."""
    d = args[0].shape[-1]
    w = kernel_width(d)
    kwargs["scale"] = 1.0 / math.sqrt(d)
    if w == d:
        return fn(*args, **kwargs)
    pad = torch.nn.functional.pad
    out = fn(*(pad(x, (0, w - d)) if _head_tensor(x, d) else x
               for x in args), **kwargs)

    def cut(y):
        return y[..., :d] if _head_tensor(y, w) else y

    return tuple(cut(y) for y in out) if isinstance(out, tuple) else cut(out)


def bwd_turn(kt: int, i: int, n_qt: int, n_g: int) -> Tuple[int, int, int]:
    """(tile, count, next) of the add that key tile kt makes at step i of
    the bf16 main kernel (`csrc/flash_bwd.cu::bwd_turn`, the same function):
    it adds into q tile (kt + i) mod n_qt after `count` earlier adds to that
    tile from its group of n_g consecutive key tiles (those of kt+1, ...,
    kt+i mod n_qt that lie in the group), waiting for the tile's turn
    counter to read `count`, and sets the counter to `next` once it is in
    (0 after the group's last add to the tile)."""
    a = kt // n_g * n_g
    m, l = min(n_g, n_qt - a), kt - a
    count = min(i, m - 1 - l) + max(0, i + 1 - (n_qt - l))
    return ((kt + i) % n_qt, count, 0 if count + 1 == m else count + 1)


def bwd_groups(n_qt: int, blocks: int) -> int:
    """The accumulator slices (groups of key tiles) a head of n_qt q tiles
    needs when the main kernel's cooperative grid holds `blocks` blocks:
    each group's n_g = ceil(n_qt / groups) key tiles must be resident at
    once."""
    return -(-n_qt // blocks)


# ----- kernel wrappers ----------------------------------------------------


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_INDEX = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {
    # dtype, head_dim, q, k, v, mask, o, lse, B, H, S, strides, scale,
    # seed, thresh, inv_keep, global head index, stream
    ("flash_fwd", "flash_fwd"): [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _STRIDES, _F, _U, _U, _F, _INDEX, _P],
    # head_dim, q, k, v, do, mask, lse, delta, dq, B, H, S, strides, scale,
    # seed, thresh, inv_keep, global head index, stream (f32)
    ("flash_bwd", "flash_bwd_dq"): [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _STRIDES, _F, _U, _U, _F, _INDEX,
                                    _P],
    # ..., dk, dv, ...
    ("flash_bwd", "flash_bwd_dkv"): [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _STRIDES, _F, _U, _U, _F,
                                     _INDEX, _P],
    # head_dim
    ("flash_bwd", "flash_bwd_main_blocks"): [_I],
    # head_dim, o, do, lse, delta, lse2, acc, turns, B, H, S, S_pad, groups,
    # strides, stream
    ("flash_bwd", "flash_bwd_prep"): [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _STRIDES, _P],
    # head_dim, q, k, v, do, mask, lse2, delta, acc, turns, dk, dv, B, H, S,
    # S_pad, groups, strides, scale, seed, thresh, inv_keep, global head
    # index, stream
    ("flash_bwd", "flash_bwd_main"): [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                                      _F, _U, _U, _F, _INDEX, _P],
    # head_dim, acc, dq, B, H, S, S_pad, groups, strides, scale, stream
    ("flash_bwd", "flash_bwd_post"): [_I, _P, _P, _I, _I, _I, _I, _I,
                                      _STRIDES, _F, _P],
    # order, out, B, H, S, seed, thresh, global head index, stream
    ("keep_bits_dump", "keep_bits_dump"): [_I, _P, _I, _I, _I, _U, _U,
                                           _INDEX, _P],
}


def _index_arg(h: int, index=None):
    """The kernels' (b_off, h_off, h_tot) array: `index`, else (0, 0, H)."""
    return (ctypes.c_uint32 * 3)(*(index or (0, 0, h)))


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
    if q.shape[-1] not in KERNEL_WIDTHS:  # with_kernel_width pads to one
        raise ValueError(f"{name} takes head dims {KERNEL_WIDTHS}, got "
                         f"{q.shape[-1]}")
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{name}: tensors must be on one device")
    b = q.shape[0]
    for x in tensors:
        # rows are read as 16-byte vectors and, in bf16, through TMA tensor
        # maps: a 16-byte aligned base and strides of whole 16 bytes
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
    """Raises on what the forward kernels do not take; the bf16 kernel reads
    q, k, v and writes o through TMA tensor maps, which take exactly the
    layouts `_check_qkv` admits."""
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


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


_CPU_BWD = ("the backward kernels take CUDA tensors; CPU tensors go through "
            "flash_attention_bwd's plain version")
_F32_ONLY = ("the dq and dk/dv kernels take float32; bfloat16 goes through "
             "flash_attention_bwd's pre-pass, main kernel and post-pass")


def _bshd(like: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) tensor laid out (B, S, H, D) in memory, so
    merging the heads back is a view."""
    b, h, s, d = like.shape
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _fwd_launch(q, k, v, mask, dropout_p, seed, index, *, scale):
    """The forward kernel at a kernel width (`with_kernel_width`)."""
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    _check(q, k, v, mask)
    b, h, s, d = q.shape
    mask = _mask_i32(mask, b, s, q.device)
    o = _bshd(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    rc = _fn("flash_fwd", "flash_fwd")(
        DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, s,
        _strides(q, k, v, o), scale, seed_u, thresh, inv_keep,
        _index_arg(h, index), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed (code {rc})")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, seed: int = 0, index=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: (o (B, H, S, D), lse (B*H, S) f32).

    q, k, v: (B, H, S, D), any B*H and S, head dim up to 128 (16, 32, 64
    and 128 as they are, others zero-padded to the next of them:
    `with_kernel_width`), float32 or bfloat16; the head dim must be
    contiguous, the data 16-byte aligned and the other strides multiples of
    8 elements (a head-split view of a (B, S, H*D) projection is taken as
    is; anything else raises). mask: (B, S) key keep-mask. dropout_p > 0
    drops the probabilities by the keep bits of `seed` (int32) at the heads'
    global `index` (b_off, h_off, h_tot; default (0, 0, H)). The returned o
    is laid out (B, S, H, D) in memory at a kernel width. bf16 CUDA tensors
    go through the TMA/wgmma kernel, f32 CUDA tensors through the f32
    kernel, CPU tensors through `attention_reference_lse`.
    `flash_attention.launches` counts kernel launches."""
    _dropout_args(dropout_p, seed)
    if not _on_cuda("flash_attention", q):
        return attention_reference_lse(q, k, v, mask, dropout_p, seed, index)
    return with_kernel_width(_fwd_launch, q, k, v, mask, dropout_p, seed,
                             index)


flash_attention.launches = 0


def _check_bwd(q, k, v, o, do, mask):
    """Raises on what the backward kernels do not take: the forward's
    checks on q, k, v, O and dO. Their rows are read as 16-byte vectors and,
    in bf16, through TMA tensor maps, which take exactly these layouts."""
    _check_qkv("flash_bwd", (q, k, v, o, do), mask)


def _dq_launch(q, k, v, mask, lse, delta, do, dropout_p, seed, index, *,
               scale):
    _check_qkv("flash_bwd_dq", (q, k, v, do), mask)
    if q.dtype != torch.float32:
        raise TypeError(_F32_ONLY)
    b, h, s, d = q.shape
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    mask = _mask_i32(mask, b, s, q.device)
    dq = _bshd(q)
    rc = _fn("flash_bwd", "flash_bwd_dq")(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, h, s, _strides(q, k, v, do, dq), scale, seed_u,
        thresh, inv_keep, _index_arg(h, index), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed (code {rc})")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dq(q, k, v, mask, lse, delta, do,
                           dropout_p: float = 0.0, seed: int = 0, index=None
                           ) -> torch.Tensor:
    """dq of the f32 flash backward (`_flash_bwd_dq_kernel`), (B, H, S, D)
    laid out (B, S, H, D) at a kernel width. lse, delta: (B*H, S) f32.
    float32 CUDA tensors only: bf16 goes through `flash_attention_bwd`'s
    three launches, and the CPU takes `attention_bwd_reference` through
    `flash_attention_bwd`."""
    if not _on_cuda("flash_attention_bwd_dq", q):
        raise ValueError(_CPU_BWD)
    return with_kernel_width(_dq_launch, q, k, v, mask, lse, delta, do,
                             dropout_p, seed, index)


flash_attention_bwd_dq.launches = 0


def _dkv_launch(q, k, v, mask, lse, delta, do, dropout_p, seed, index, *,
                scale):
    _check_qkv("flash_bwd_dkv", (q, k, v, do), mask)
    if q.dtype != torch.float32:
        raise TypeError(_F32_ONLY)
    b, h, s, d = q.shape
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    mask = _mask_i32(mask, b, s, q.device)
    dk, dv = _bshd(k), _bshd(v)
    rc = _fn("flash_bwd", "flash_bwd_dkv")(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, s,
        _strides(q, k, v, do, dk, dv), scale, seed_u, thresh, inv_keep,
        _index_arg(h, index), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed (code {rc})")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                            dropout_p: float = 0.0, seed: int = 0, index=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the f32 flash backward (`_flash_bwd_dkv_kernel`), each
    (B, H, S, D) laid out (B, S, H, D) at a kernel width. float32 CUDA
    tensors only."""
    if not _on_cuda("flash_attention_bwd_dkv", q):
        raise ValueError(_CPU_BWD)
    return with_kernel_width(_dkv_launch, q, k, v, mask, lse, delta, do,
                             dropout_p, seed, index)


flash_attention_bwd_dkv.launches = 0


def _check_f32_rows(name, like, **rows):
    """Raises unless each of `rows` (name=(tensor, shape)) is a contiguous
    float32 tensor of that shape on `like`'s device: the kernels read lse,
    lse2, delta and the dq accumulator as dense f32 rows."""
    for arg, (x, shape) in rows.items():
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != like.device):
            raise ValueError(f"{name}: {arg} must be a contiguous float32 "
                             f"{shape} tensor on {like.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _check_bf16(name, x):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bfloat16, got {x.dtype}")


_main_blocks = {}  # (device index, head width) -> the main kernel's grid


def main_kernel_blocks(d: int, device) -> int:
    """The blocks of the bf16 main kernel at head width d that `device`
    holds at once: its cooperative grid (`csrc/flash_bwd.cu`)."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), d)
    if key not in _main_blocks:
        with torch.cuda.device(key[0]):
            n = _fn("flash_bwd", "flash_bwd_main_blocks")(d)
        if n <= 0:
            raise RuntimeError(f"flash_bwd_main cannot launch on {device} "
                               f"(code {n})")
        _main_blocks[key] = n
    return _main_blocks[key]


def bwd_schedule_words(b: int, h: int, groups: int, n_qt: int) -> int:
    """The int32 words of the main kernel's schedule counters: a turn
    counter a (batch*head, group, q tile), then its work counter (the
    tickets of the items claimed past each block's first)."""
    return b * h * groups * n_qt + 1


def _check_turns(name, turns, b, h, groups, n_qt):
    """Raises unless `turns` is the main kernel's contiguous int32 vector of
    schedule counters (`bwd_schedule_words`), as flash_bwd_prep makes it."""
    shape = (bwd_schedule_words(b, h, groups, n_qt),)
    if (tuple(turns.shape) != shape or turns.dtype != torch.int32
            or not turns.is_contiguous()):
        raise ValueError(f"{name}: turns must be flash_bwd_prep's contiguous "
                         f"int32 {shape} turn counters, got {turns.dtype} "
                         f"{tuple(turns.shape)}")


def _acc_groups(name, acc, b, h, s_pad) -> int:
    """The slices of a dq accumulator (B*H, groups * S_pad, D)."""
    if acc.dim() != 3 or acc.shape[0] != b * h or acc.shape[1] % s_pad:
        raise ValueError(f"{name}: acc must be (B*H, groups * {s_pad}, D), "
                         f"got {tuple(acc.shape)}")
    return acc.shape[1] // s_pad


def _prep_launch(o, do, lse, *, scale=None):
    """The pre-pass at a kernel width (it takes no scale)."""
    _check_qkv("flash_bwd_prep", (o, do), None)
    _check_bf16("flash_bwd_prep", o)
    b, h, s, d = o.shape
    _check_f32_rows("flash_bwd_prep", o, lse=(lse, (b * h, s)))
    s_pad = _padded_len(s)
    n_qt = s_pad // 64
    groups = bwd_groups(n_qt, main_kernel_blocks(d, o.device))
    delta = torch.empty((b * h, s_pad), dtype=torch.float32, device=o.device)
    lse2 = torch.empty_like(delta)
    acc = torch.empty((b * h, groups * s_pad, d), dtype=torch.float32,
                      device=o.device)
    turns = torch.empty(bwd_schedule_words(b, h, groups, n_qt),
                        dtype=torch.int32, device=o.device)
    rc = _fn("flash_bwd", "flash_bwd_prep")(
        d, o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lse2.data_ptr(), acc.data_ptr(), turns.data_ptr(), b, h, s, s_pad,
        groups, _strides(o, do), _stream(o))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_prep launch failed (code {rc})")
    flash_bwd_prep.launches += 1
    return delta, lse2, acc, turns


def flash_bwd_prep(o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor):
    """The bf16 backward's pre-pass (`flash_bwd_prep_kernel`): (delta, lse2,
    acc, turns), delta and lse2 as `attention_bwd_prep_reference` gives
    them, in one launch that reads bf16 O and dO once. acc: the zeroed f32
    dq accumulator (B*H, groups * S_pad, W) at the kernel width W
    (`with_kernel_width`), one slice of S_pad rows a group of key tiles
    (`bwd_groups` for this card: 1 unless S is past ~64 x the main kernel's
    grid); turns: the main kernel's zeroed int32 schedule counters
    (`bwd_schedule_words`: a turn counter a (batch*head, group, q tile),
    which fix the order of its adds into acc, then its work counter).
    bfloat16 CUDA tensors only."""
    if not _on_cuda("flash_bwd_prep", o):
        raise ValueError(_CPU_BWD)
    return with_kernel_width(_prep_launch, o, do, lse)


flash_bwd_prep.launches = 0


def _main_launch(q, k, v, mask, lse2, delta, acc, turns, do, dropout_p,
                 seed, index, *, scale):
    _check_qkv("flash_bwd_main", (q, k, v, do), mask)
    _check_bf16("flash_bwd_main", q)
    b, h, s, d = q.shape
    s_pad = _padded_len(s)
    groups = _acc_groups("flash_bwd_main", acc, b, h, s_pad)
    _check_f32_rows("flash_bwd_main", q, lse2=(lse2, (b * h, s_pad)),
                    delta=(delta, (b * h, s_pad)),
                    acc=(acc, (b * h, groups * s_pad, d)))
    _check_turns("flash_bwd_main", turns, b, h, groups, s_pad // 64)
    seed_u, thresh, inv_keep = _dropout_args(dropout_p, seed)
    mask = _mask_i32(mask, b, s, q.device)
    dk, dv = _bshd(k), _bshd(v)
    rc = _fn("flash_bwd", "flash_bwd_main")(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        mask.data_ptr(), lse2.data_ptr(), delta.data_ptr(), acc.data_ptr(),
        turns.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s, s_pad,
        groups, _strides(q, k, v, do, dk, dv), scale, seed_u, thresh,
        inv_keep, _index_arg(h, index), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_main launch failed (code {rc})")
    flash_bwd_main.launches += 1
    return dk, dv


def flash_bwd_main(q, k, v, mask, lse2, delta, acc, turns, do,
                   dropout_p: float = 0.0, seed: int = 0, index=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 backward's main kernel (`flash_bwd_main_kernel`, TPU
    `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` in one pass): (dk,
    dv), each (B, H, S, D), and dq / scale added into `acc` in a fixed
    order, so that dq's bits do not vary from run to run. lse2, delta, acc
    and turns: from `flash_bwd_prep` (the counters are 0 again when the
    kernel ends, so several launches may add into one acc, as ring
    attention's do). One cooperative launch of a persistent grid: every
    block is resident at once or the launch fails (and this raises); the
    blocks claim the (batch*head, key tile) items in order, and each wait
    for a dq turn points to a block that is running (`csrc/flash_bwd.cu`). bfloat16 CUDA tensors only; the CPU takes
    `attention_bwd_reference` through `flash_attention_bwd`."""
    if not _on_cuda("flash_bwd_main", q):
        raise ValueError(_CPU_BWD)
    return with_kernel_width(_main_launch, q, k, v, mask, lse2, delta, acc,
                             turns, do, dropout_p, seed, index)


flash_bwd_main.launches = 0


def _post_launch(acc, like, *, scale):
    _check_bf16("flash_bwd_post", like)
    if like.dim() != 4 or like.shape[-1] not in KERNEL_WIDTHS:
        raise ValueError(f"flash_bwd_post: like must be (B, H, S, D) with D "
                         f"in {KERNEL_WIDTHS}, got {tuple(like.shape)}")
    b, h, s, d = like.shape
    s_pad = _padded_len(s)
    groups = _acc_groups("flash_bwd_post", acc, b, h, s_pad)
    _check_f32_rows("flash_bwd_post", like,
                    acc=(acc, (b * h, groups * s_pad, d)))
    dq = _bshd(like)
    rc = _fn("flash_bwd", "flash_bwd_post")(
        d, acc.data_ptr(), dq.data_ptr(), b, h, s, s_pad, groups,
        _strides(dq), scale, _stream(acc))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_post launch failed (code {rc})")
    flash_bwd_post.launches += 1
    return dq


def flash_bwd_post(acc: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's post-pass (`flash_bwd_post_kernel`): dq = scale *
    (the sum of acc's slices) in bf16, (B, H, S, D) laid out (B, S, H, W)
    like the bfloat16 q `like` (at a kernel width W; scale 1 / sqrt(D));
    acc from `flash_bwd_prep`. CUDA tensors only."""
    if not _on_cuda("flash_bwd_post", acc):
        raise ValueError(_CPU_BWD)
    d = like.shape[-1]
    w = kernel_width(d)
    # `like` gives the kernel only a shape and a dtype: an empty one of the
    # kernel width stands in for a padded copy
    stand_in = like if w == d else like.new_empty(like.shape[:-1] + (w,))
    dq = _post_launch(acc, stand_in, scale=1.0 / math.sqrt(d))
    return dq if w == d else dq[..., :d]


flash_bwd_post.launches = 0


def _bwd_launch(q, k, v, mask, o, lse, do, dropout_p, seed, index, *, scale):
    """The whole backward at a kernel width (`with_kernel_width`)."""
    _check_bwd(q, k, v, o, do, mask)
    if q.dtype == torch.float32:
        delta = attention_delta(o, do)
        dq = _dq_launch(q, k, v, mask, lse, delta, do, dropout_p, seed,
                        index, scale=scale)
        dk, dv = _dkv_launch(q, k, v, mask, lse, delta, do, dropout_p, seed,
                             index, scale=scale)
        return dq, dk, dv
    delta, lse2, acc, turns = _prep_launch(o, do, lse)
    dk, dv = _main_launch(q, k, v, mask, lse2, delta, acc, turns, do,
                          dropout_p, seed, index, scale=scale)
    return _post_launch(acc, q, scale=scale), dk, dv


def flash_attention_bwd(q, k, v, mask, o, lse, do, dropout_p: float = 0.0,
                        seed: int = 0, index=None):
    """Flash backward (`flash_attention_bwd`): (dq, dk, dv) from the saved
    forward output `o` and lse. bf16 CUDA tensors: the pre-pass, the main
    kernel and the post-pass; f32 CUDA tensors: delta as one PyTorch
    reduction, then the f32 dq and dk/dv kernels; both at the kernel width
    (`with_kernel_width`: the padding is made once for the three
    launches); CPU tensors: `attention_bwd_reference`. dO is copied to a
    contiguous tensor only when its head dim or its strides are not what
    the kernels read; any other layout the kernels cannot take raises."""
    if not _on_cuda("flash_attention_bwd", q):
        return attention_bwd_reference(q, k, v, mask, o, lse, do, dropout_p,
                                       seed, index)
    if do.stride(-1) != 1 or any(st % 8 for st in do.stride()[:3]):
        do = do.contiguous()
    return with_kernel_width(_bwd_launch, q, k, v, mask, o, lse, do,
                             dropout_p, seed, index)


_DUMP_ORDERS = {"fwd": 0, "dkv": 1}


def dump_keep_bits(order: str, seed: int, b: int, h: int, s: int,
                   dropout_p: float, device="cuda", index=None
                   ) -> torch.Tensor:
    """The keep bits the bf16 attention kernels regenerate, (B, H, S, S)
    bool, written by `csrc/keep_bits_dump.cu` through the kernels' own
    fragment maps (`csrc/keep_bits.cuh`) in the forward's order ("fwd": per
    64-row q tile, over the key tiles) or the main backward's ("dkv": per
    64-key tile, over the q tiles from its own), each head at its global
    `index`. On the CPU both orders are the plain `keep_bits`."""
    if order not in _DUMP_ORDERS:
        raise ValueError(f"order must be one of {tuple(_DUMP_ORDERS)}")
    device = torch.device(device)
    if not _on_cuda("dump_keep_bits", torch.empty(0, device=device)):
        return keep_bits(seed, b, h, s, dropout_p, device, index)
    out = torch.empty((b, h, s, s), dtype=torch.bool, device=device)
    rc = _fn("keep_bits_dump", "keep_bits_dump")(
        _DUMP_ORDERS[order], out.data_ptr(), b, h, s, seed & _M32,
        keep_threshold(dropout_p), _index_arg(h, index),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"keep_bits_dump launch failed (code {rc})")
    dump_keep_bits.launches += 1
    return out


dump_keep_bits.launches = 0


# ----- differentiable entry -----------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (`_flash_attention_ad`): the forward
    saves q, k, v, mask, seed, the heads' global index, O and lse; the
    backward is `flash_attention_bwd`, whose kernels regenerate the
    forward's keep bits from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed: int, dropout_p: float, index=None):
        o, lse = flash_attention(q, k, v, mask, dropout_p, seed, index)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.seed, ctx.dropout_p, ctx.index = seed, dropout_p, index
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, do,
                                         ctx.dropout_p, ctx.seed, ctx.index)
        return dq, dk, dv, None, None, None, None


def multihead_attention(q, k, v, mask=None, dropout_p: float = 0.0,
                        seed: Optional[int] = None, index=None):
    """Attention context (B, H, S, D): the flash kernels for CUDA tensors,
    the plain versions for CPU tensors. dropout_p > 0 (training, HF
    "probs" mode) needs an int32 `seed` for the keep bits, drawn at the
    heads' global `index` (b_off, h_off, h_tot; default (0, 0, H))."""
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout_p > 0 needs a seed")
    seed = 0 if seed is None else seed
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if mask is None:
            mask = torch.ones(q.shape[:1] + q.shape[2:3], dtype=torch.int32,
                              device=q.device)
        return FlashAttention.apply(q, k, v, mask, seed, dropout_p, index)
    return flash_attention(q, k, v, mask, dropout_p, seed, index)[0]
