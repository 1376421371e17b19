"""Fast float32 sine for the INR hot loop — plain PyTorch version.

Torch port of brief_pytorch_tpu/ops/fast_math.py:37-168, with the same
constants.  The CUDA kernels carry the same function as a
`__device__ __forceinline__` in csrc/fast_math.cuh; this module is its
plain version (CPU tests, the autograd chain, and the reference the card's
check holds the device copy against).

  * Cody-Waite two-step reduction by 2π (6.28125 is exact in float32, the
    1.94e-3 tail restores the rest), valid to ~1e-5 absolute for
    |x| <= ~2e3 — far beyond any SIREN activation;
  * fold to [-π/2, π/2] (sin(π−r) = sin r);
  * degree-9 odd (sin) and degree-8 even (cos) minimax polynomials:
    float32 error <= 2e-6 for |x| <= 40, <= 8e-6 for |x| <= 200.

float64 inputs and BRIEF_TPU_EXACT_SINE=1 fall back to torch.sin/cos.
"""
from __future__ import annotations

import os

import torch

_INV_2PI = 0.15915494309189535
_C1 = 6.28125                       # exact in float32
_C2 = 1.9353071795864769e-3        # 2*pi - _C1
_PI = 3.141592653589793
_HALF_PI = 1.5707963267948966
# odd minimax coefficients for sin on [-pi/2, pi/2]
_S0 = 9.99999977e-01
_S1 = -1.66666476e-01
_S2 = 8.33290001e-03
_S3 = -1.98009088e-04
_S4 = 2.59051028e-06
# even minimax coefficients for cos on [-pi/2, pi/2]
_K0 = 9.99999953e-01
_K1 = -4.99999054e-01
_K2 = 4.16635848e-02
_K3 = -1.38537053e-03
_K4 = 2.31539532e-05


def exact_sine() -> bool:
    """BRIEF_TPU_EXACT_SINE=1 selects exact sin/cos everywhere (read at
    call time; the CUDA build reads it when it compiles the kernels)."""
    return os.environ.get("BRIEF_TPU_EXACT_SINE") == "1"


def _reduce(x: torch.Tensor):
    """(r in [-pi/2, pi/2], flip) with sin(x) = sin(r), cos(x) = ±cos(r)."""
    k = torch.round(x * _INV_2PI)
    r = x - k * _C1
    r = r - k * _C2                        # r in [-pi, pi]
    flip = r.abs() > _HALF_PI              # outer quadrants: cos < 0 side
    r = torch.where(r > _HALF_PI, _PI - r, r)
    r = torch.where(r < -_HALF_PI, -_PI - r, r)
    return r, flip


def _sin_poly(r: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    p = _S4 * r2 + _S3
    p = p * r2 + _S2
    p = p * r2 + _S1
    p = p * r2 + _S0
    return r * p


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) for float32 tensors with |x| <~ 2e3."""
    if exact_sine() or x.dtype == torch.float64:
        return torch.sin(x)
    r, _ = _reduce(x)
    return _sin_poly(r, r * r)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) = sin(x + pi/2) through the same fast path (JAX
    fast_math.py:78-83)."""
    if exact_sine() or x.dtype == torch.float64:
        return torch.cos(x)
    return fast_sin(x + _HALF_PI)


def fast_sincos(x: torch.Tensor):
    """(sin(x), cos(x)) sharing one Cody-Waite reduction."""
    if exact_sine() or x.dtype == torch.float64:
        return torch.sin(x), torch.cos(x)
    r, flip = _reduce(x)
    r2 = r * r
    s = _sin_poly(r, r2)
    q = _K4 * r2 + _K3
    q = q * r2 + _K2
    q = q * r2 + _K1
    q = q * r2 + _K0
    return s, torch.where(flip, -q, q)


def fast_sincos_device(x: torch.Tensor):
    """(sin, cos) of a contiguous float32 CUDA tensor through the device
    copy in csrc/fast_math.cuh (one elementwise kernel, csrc/fast_math.cu).

    Exists so that the card can hold the device copy against this module's
    plain version; the fused kernels inline the header themselves."""
    import ctypes

    from brief_pytorch_tpu_torch.ops import build
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError("fast_sincos_device takes a contiguous float32 "
                         "CUDA tensor")
    lib = build.library("fast_math", {"brief_fast_sincos": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p]})
    s, c = torch.empty_like(x), torch.empty_like(x)
    build.check(lib.brief_fast_sincos(
        x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream), "fast_sincos")
    return s, c


def fast_sin_cached(x: torch.Tensor) -> torch.Tensor:
    """fast_sin whose gradient is the cos of the shared reduction.

    The JAX package's custom VJP (fast_math.py:139-168): the forward
    computes (sin, cos) once and the backward is g * cos, not the
    polynomial's derivative.  Written without an autograd.Function: the
    value is s (x - x.detach() is exactly 0) and d/dx is cos."""
    if exact_sine() or x.dtype == torch.float64:
        return torch.sin(x)
    with torch.no_grad():
        s, c = fast_sincos(x)
    if not x.requires_grad:
        return s
    return s + (x - x.detach()) * c
