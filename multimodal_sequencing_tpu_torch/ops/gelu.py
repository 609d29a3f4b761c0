"""GELU for the encoder MLP (counterpart of `ops/gelu.py`).

The same four implementations as the JAX package, computed the same way:

  erf       exact erf GELU (`F.gelu`).
  fast_erf  erf through the Abramowitz & Stegun 7.1.26 rational + exp form,
            the asymptotic erfc series on the deep negative tail, saturation
            at +5.55; custom backward Phi + x phi.
  logit_erf gelu(x) = x * sigmoid(u(x)) with u = x * P(x^2), the JAX
            package's 12-coefficient fit, assembled in the half-exponent form
            of `_logit_parts_f32`; custom backward. The default.
  tanh      the tanh approximation (HF `gelu_new`).

`fast_erf` and `logit_erf` are `torch.autograd.Function`s that compute in
f32 and save only their input, so the backward recomputes from it rather
than keeping f32 tensors, as the JAX `custom_vjp`s do. Both follow XLA's
arithmetic: the polynomials by fused multiply-adds, and f32 denormal results
flushed to zero.

`logit_erf`, the default, runs on the card as one elementwise pass forward
and one backward (`csrc/gelu.cu`; in plain PyTorch it takes ~35 passes over
the MLP activation); `gelu_logit_erf_reference` and
`gelu_logit_erf_bwd_reference` are its plain versions, which CPU tensors
take. The JAX package leaves these elementwise ops to XLA (no Pallas
kernel).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._build import DTYPE_CODE

INV_SQRT_2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
INV_SQRT_PI = 0.5641895835477563
# A&S 7.1.26 coefficients
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_TAIL_X = -4.8
_POS_SAT_X = 5.55

_LOGIT_CLIP_LO = -14.5
_LOGIT_CLIP_HI = 5.7
_LOGIT_COEFFS = (
    1.5896136389400737,
    0.07718187553182493,
    -0.0011652754881688425,
    1.7963775574361492e-05,
    -1.5475305063924886e-07,
    -1.646850482448538e-10,
    2.1211035997926802e-11,
    -2.604158256316201e-13,
    1.6714618655303135e-15,
    -6.2150528706248856e-18,
    1.2672366766358843e-20,
    -1.0994478291490898e-23,
)


_F32_MIN_NORMAL = 1.1754943508222875e-38


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush f32 denormals to signed zero, as XLA (CPU and TPU) does; the
    JAX forms' outputs rely on it near the bf16-zero crossing."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, x * 0.0, x)


def _fma_horner(coeffs, s: torch.Tensor) -> torch.Tensor:
    """Horner's rule over f32 `coeffs` (highest first) with each step
    p * s + c rounded once, as a fused multiply-add: the f32 product is
    exact in f64, so the f64 sum rounded to f32 is the FMA."""
    s64 = s.double()
    p = torch.full_like(s, float(torch.tensor(coeffs[0], dtype=torch.float32)))
    for c in coeffs[1:]:
        c32 = float(torch.tensor(c, dtype=torch.float32))
        p = (p.double() * s64 + c32).float()
    return p


def _fast_erf_parts_f32(xf: torch.Tensor):
    """Returns (gelu(x), e^{-x^2/2}, cdf) in f32."""
    u = xf * INV_SQRT_2
    a = u.abs()
    e = torch.exp(-a * a)
    t = 1.0 / (1.0 + _AS_P * a)
    poly = t * (_AS_A[0] + t * (_AS_A[1] + t * (
        _AS_A[2] + t * (_AS_A[3] + t * _AS_A[4]))))
    erf = torch.sign(u) * (1.0 - poly * e)
    cdf = 0.5 * (1.0 + erf)
    out = xf * cdf
    # deep negative tail: relative-accuracy erfc via the asymptotic series
    ia = 1.0 / torch.clamp(a, min=1.0)
    ia2 = ia * ia
    erfc_tail = (e * ia * INV_SQRT_PI
                 * (1.0 + ia2 * (-0.5 + ia2 * (0.75 - 1.875 * ia2))))
    tail = xf < _TAIL_X
    out = torch.where(tail, 0.5 * xf * erfc_tail, out)
    cdf = torch.where(tail, 0.5 * erfc_tail, cdf)
    pos = xf >= _POS_SAT_X
    out = torch.where(pos, xf, out)
    cdf = torch.where(pos, 1.0, cdf)
    return out, e, cdf


def _logit_parts_f32(xf: torch.Tensor):
    """Returns (gelu(x), sigma(u), u'(x)) in f32; the forward value in the
    half-exponent form t = e^{-|u|/2}, negative side y = (x_c t)(t d), which
    keeps the bf16-zero crossing out of f32 denormals."""
    xc = torch.clamp(xf, _LOGIT_CLIP_LO, _LOGIT_CLIP_HI)
    s = xc * xc
    p = _fma_horner(_LOGIT_COEFFS[::-1], s)
    # P'(s): coefficients i * c_i
    dps = _fma_horner([i * c for i, c in enumerate(_LOGIT_COEFFS)][:0:-1], s)
    u = p * xc
    t = torch.exp(-0.5 * u.abs())
    d = 1.0 / (1.0 + t * t)
    pos = xf >= 0
    y = torch.where(pos, xf * d, (xc * t) * (t * d))
    sig = torch.where(pos, d, t * (t * d))
    du = p + 2.0 * s * dps
    return y, sig, du


def gelu_logit_erf_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain forward of `gelu_logit_erf`, in f32, returned in x's dtype."""
    return _ftz(_logit_parts_f32(x.float())[0]).to(x.dtype)


def gelu_logit_erf_bwd_reference(x: torch.Tensor, g: torch.Tensor):
    """Plain backward: (sigma + x sigma (1 - sigma) u'(x)) * g."""
    xf = x.float()
    _, sig, du = _logit_parts_f32(xf)
    d = sig + xf * sig * (1.0 - sig) * du
    return _ftz(d * g.float()).to(g.dtype)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # dtype, x, y, n, stream
    "gelu_logit_erf_fwd": [_I, _P, _P, _L, _P],
    # dtype, x, g, dx, n, stream
    "gelu_logit_erf_bwd": [_I, _P, _P, _P, _L, _P],
}
_fns = {}


def _fn(name: str):
    """`csrc/gelu.cu`'s entry `name`; both entries get their signatures
    once, when the library loads."""
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("gelu")
        for entry, signature in _SIGNATURES.items():
            f = getattr(lib, entry)
            f.argtypes, f.restype = signature, _I
            _fns[entry] = f
        fn = _fns[name]
    return fn


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _empty_on_phase(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised contiguous tensor like contiguous `x` whose data
    starts at the same offset from a 16-byte boundary, so that the kernel's
    16-byte vectors line up in both (x may be a view with a storage
    offset)."""
    k = x.data_ptr() % 16 // x.element_size()
    if k == 0:
        return torch.empty_like(x)
    return torch.empty(x.numel() + k, dtype=x.dtype,
                       device=x.device)[k:].view(x.shape)


def _launch(name: str, x: torch.Tensor, g: torch.Tensor | None = None):
    """Run `csrc/gelu.cu`'s `name` over x (and g) into a new tensor like
    x. The kernel takes any element offset: a head and a tail that are not
    whole 16-byte vectors go through its scalar path."""
    if x.dtype not in DTYPE_CODE or (g is not None and g.dtype != x.dtype):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {x.dtype}"
                        + ("" if g is None else f" and {g.dtype}"))
    if g is not None and (g.shape != x.shape or g.device != x.device):
        raise ValueError(f"{name}: tensors must share shape and device")
    x = _contiguous(x)
    out = _empty_on_phase(x)
    # the raw handle of the current stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    if g is None:
        rc = _fn(name)(DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                       x.numel(), stream)
    else:
        rc = _fn(name)(DTYPE_CODE[x.dtype], x.data_ptr(),
                       _contiguous(g).data_ptr(), out.data_ptr(), x.numel(),
                       stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (code {rc})")
    return out


def gelu_logit_erf_fwd(x: torch.Tensor) -> torch.Tensor:
    """logit_erf forward: the kernel for a CUDA tensor, the plain version
    for a CPU tensor. `.launches` counts kernel launches."""
    if x.is_cpu:
        return gelu_logit_erf_reference(x)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch("gelu_logit_erf_fwd", x)
    gelu_logit_erf_fwd.launches += 1
    return out


def gelu_logit_erf_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """logit_erf backward (input gradient): kernel or plain version, as
    `gelu_logit_erf_fwd`; g is taken in x's dtype."""
    if x.is_cpu:
        return gelu_logit_erf_bwd_reference(x, g)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch("gelu_logit_erf_bwd", x,
                  g if g.dtype == x.dtype else g.to(x.dtype))
    gelu_logit_erf_bwd.launches += 1
    return out


gelu_logit_erf_fwd.launches = 0
gelu_logit_erf_bwd.launches = 0


class GeluLogitErf(torch.autograd.Function):
    """`gelu_logit_erf`: forward in f32, input saved, backward
    sigma + x sigma (1 - sigma) u'(x) recomputed from it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_logit_erf_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return gelu_logit_erf_bwd(x, g)


class GeluFastErf(torch.autograd.Function):
    """`gelu_fast_erf`: forward in f32, input saved, backward Phi + x phi."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _ftz(_fast_erf_parts_f32(x.float())[0]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.float()
        _, e, cdf = _fast_erf_parts_f32(xf)
        d = cdf + xf * (INV_SQRT_2PI * e)
        return _ftz(d * g.float()).to(g.dtype)


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """Dispatch by EncoderConfig.gelu_impl."""
    if impl == "logit_erf":
        return GeluLogitErf.apply(x)
    if impl == "fast_erf":
        return GeluFastErf.apply(x)
    if impl == "tanh":
        return F.gelu(x, approximate="tanh")
    if impl == "erf":
        return F.gelu(x)
    raise ValueError(f"unknown gelu impl {impl!r}")
