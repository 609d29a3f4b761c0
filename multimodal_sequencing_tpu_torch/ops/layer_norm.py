"""Flax-form LayerNorm: the fused kernel (`csrc/layer_norm.cu`) and its plain
version.

`flax.linen.LayerNorm` as the JAX encoder runs it (Flax 0.12 defaults,
`use_fast_variance=True`, `force_float32_reductions=True`): f32 mean and
E[x^2], var = max(0, E[x^2] - mean^2), y = (x - mean) * (rsqrt(var + eps) *
weight) + bias with f32 weight and bias, y in the compute dtype.

  * `layer_norm_reference` — plain PyTorch of that formula; autograd gives
    its backward. The CPU path and the oracle the kernels are held to.
  * `layer_norm` — the differentiable entry: for CUDA tensors the forward
    and backward kernels (or raise), for CPU tensors the plain version.
    `layer_norm_fwd.launches` and `layer_norm_bwd.launches` count kernel
    launches; the backward is one launch that yields dx, dw and db.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._build import DTYPE_CODE

MAX_FEATURES = 1024


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain Flax-form LayerNorm over the last dim, returned in `dtype`."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((xf - mean) * mul + bias).to(dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype, x, w, b, y, rows, N, eps, stream
    "layer_norm_fwd": [_I, _P, _P, _P, _P, _I, _I, _F, _P],
    # dtype, x, dy, w, dx, part, dw and db, tickets, rows, N, blocks, eps,
    # stream
    "layer_norm_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}


_fns = {}


def _fn(name: str):
    """`csrc/layer_norm.cu`'s entry `name`; both entries get their
    signatures once, when the library loads."""
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("layer_norm")
        for entry, signature in _SIGNATURES.items():
            f = getattr(lib, entry)
            f.argtypes, f.restype = signature, _I
            _fns[entry] = f
        fn = _fns[name]
    return fn


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def bwd_grid(rows: int, dtype: torch.dtype, sms: int) -> int:
    """Blocks of the backward kernel (csrc/layer_norm.cu) for `rows` rows on
    a card of `sms` SMs: one block an SM (16 warps in bf16, 8 in f32; the
    cooperative launch needs them all resident), but no more blocks than
    give each warp a row; each block takes an equal contiguous share of the
    rows."""
    warps = 16 if dtype == torch.bfloat16 else 8
    return min(sms, -(-rows // warps))


def bwd_partial_bytes(rows: int, n: int, dtype: torch.dtype, sms: int) -> int:
    """Bytes of the backward's f32 partials of dw and db, one (2, N) row a
    block (scratch beyond what the function reads and writes)."""
    return bwd_grid(rows, dtype, sms) * 2 * n * 4


# (device index, stream) -> the backward's two int32 barrier counters:
# zeroed once, left zero by every launch on that stream
_TICKETS = {}


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return t


def _check(x, weight, bias, dtype):
    n = x.shape[-1]
    if x.dtype not in DTYPE_CODE or dtype != x.dtype:
        raise TypeError(f"the layer_norm kernels take float32 or bfloat16 "
                        f"input in the output dtype, got {x.dtype} -> {dtype}")
    if not 0 < n <= MAX_FEATURES:
        raise ValueError(f"the layer_norm kernels take 1..{MAX_FEATURES} "
                         f"features, got {n}")
    for p in (weight, bias):
        if p.dtype != torch.float32 or tuple(p.shape) != (n,) or \
                p.device != x.device:
            raise ValueError("weight and bias must be f32 (features,) "
                             "tensors on the input's device")


def layer_norm_fwd(x, weight, bias, eps: float) -> torch.Tensor:
    """Forward kernel: y in x's dtype. CUDA tensors only. Rows that are
    whole 16-byte vectors at 16-byte aligned addresses take the kernel's
    vector path, any other row (such as a view at an odd storage offset)
    its scalar path."""
    xc = _contiguous(x)
    y = torch.empty_like(xc)
    n = x.shape[-1]
    rc = _fn("layer_norm_fwd")(
        DTYPE_CODE[x.dtype], xc.data_ptr(), _contiguous(weight).data_ptr(),
        _contiguous(bias).data_ptr(), y.data_ptr(), xc.numel() // n, n, eps,
        # the raw handle of the current stream, without building a Stream
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed (code {rc})")
    layer_norm_fwd.launches += 1
    return y


def layer_norm_bwd(x, dy, weight, eps: float):
    """Backward kernel: (dx in x's dtype, dweight, dbias in f32), all three
    from one launch; dweight and dbias are summed in a fixed order, so a
    rerun gives the same bits. The row statistics are recomputed from x by
    the forward's own routine, so they equal the forward's bit for bit.
    CUDA tensors only."""
    xc = _contiguous(x)
    dyc = _contiguous(dy if dy.dtype == x.dtype else dy.to(x.dtype))
    n = x.shape[-1]
    rows = xc.numel() // n
    device = x.get_device()
    blocks = bwd_grid(rows, x.dtype, _sm_count(device))
    stream = torch._C._cuda_getCurrentRawStream(device)
    dx = torch.empty_like(xc)
    part = torch.empty(blocks * 2 * n, dtype=torch.float32, device=x.device)
    dwb = torch.empty(2 * n, dtype=torch.float32, device=x.device)
    rc = _fn("layer_norm_bwd")(
        DTYPE_CODE[x.dtype], xc.data_ptr(), dyc.data_ptr(),
        _contiguous(weight).data_ptr(), dx.data_ptr(), part.data_ptr(),
        dwb.data_ptr(), _tickets(x.device, stream).data_ptr(),
        rows, n, blocks, eps, stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd launch failed (code {rc})")
    layer_norm_bwd.launches += 1
    return dx, dwb[:n], dwb[n:]


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """The kernels as one differentiable op; the backward recomputes the
    row statistics from the saved input."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, dy, weight, ctx.eps)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """Flax-form LayerNorm over the last dim, in `dtype`: the kernels for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu, not {x.device}")
    _check(x, weight, bias, dtype)
    return LayerNormFunction.apply(x, weight, bias, eps)
