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
    launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import DTYPE_CODE

MAX_FEATURES = 1024
_BWD_ROWS = 16  # rows per backward block (csrc/layer_norm.cu)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain Flax-form LayerNorm over the last dim, returned in `dtype`."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((xf - mean) * mul + bias).to(dtype)


def _fn(name: str, nargs: int):
    fn = getattr(_build.load("layer_norm"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * nargs
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
    """Forward kernel: y in x's dtype. CUDA tensors only."""
    xc = x.contiguous()
    y = torch.empty_like(xc)
    n = x.shape[-1]
    rc = _fn("layer_norm_fwd", 4)(
        DTYPE_CODE[x.dtype], xc.data_ptr(), weight.contiguous().data_ptr(),
        bias.contiguous().data_ptr(), y.data_ptr(), xc.numel() // n, n, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed (code {rc})")
    layer_norm_fwd.launches += 1
    return y


def layer_norm_bwd(x, dy, weight, eps: float):
    """Backward kernel: (dx in x's dtype, dweight, dbias in f32). CUDA
    tensors only."""
    xc, dyc = x.contiguous(), dy.to(x.dtype).contiguous()
    n = x.shape[-1]
    rows = xc.numel() // n
    blocks = (rows + _BWD_ROWS - 1) // _BWD_ROWS
    dx = torch.empty_like(xc)
    dw_part = torch.empty((blocks, n), dtype=torch.float32, device=x.device)
    db_part = torch.empty_like(dw_part)
    rc = _fn("layer_norm_bwd", 6)(
        DTYPE_CODE[x.dtype], xc.data_ptr(), dyc.data_ptr(),
        weight.contiguous().data_ptr(), dx.data_ptr(), dw_part.data_ptr(),
        db_part.data_ptr(), rows, n, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd launch failed (code {rc})")
    layer_norm_bwd.launches += 1
    return dx, dw_part.sum(0), db_part.sum(0)


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
