"""The card's arithmetic on the CPU, shared by the kernels' CPU models
(ops/stream.py, ops/chain_stream.py, ops/fused_siren.py,
ops/fused_decode.py, ops/fused_train.py): fmaf, layer 0 from the
coordinates by fmaf, the TF32 rounding and 3xTF32 splits, one
mma.sync.m16n8k8 TF32 sum bit for bit, and the plain chain's activation.
It imports no other module of the package but fast_math, so any of them
can import it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from brief_pytorch_tpu_torch.ops.fast_math import fast_sin

GROUP_K = 32                 # kGroupK of csrc/chain_tc.cuh


def act(z: torch.Tensor, act: str, w0: float) -> torch.Tensor:
    """The plain chain's activation of z (fast_sin for the sine)."""
    if act == "sine":
        return fast_sin(w0 * z)
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "none":
        return z
    raise ValueError(act)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c): the product exact (float64 holds it), one rounding
    to float32 (up to a double rounding of the sum, within the
    tolerances)."""
    return (a.double() * b.double() + c.double()).float()


def z_from_x(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """z_1 (B, F, N) of coordinates x (B, C, N) as z_from_x computes it:
    the bias, then one fmaf a channel."""
    z = b[:, :, None].expand(-1, -1, x.shape[-1]).float()
    for c in range(x.shape[1]):
        z = fma(x[:, c:c + 1, :], w[:, c, :, None], z)
    return z


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded as cvt.rna.tf32.f32 rounds: to 10 mantissa bits, the
    nearest, ties away from zero (inf and NaN kept)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 x as the narrow kernel feeds them to the
    tensor cores for 3xTF32 (csrc/fused_train.cu split_tf32): big = x
    rounded as cvt.rna.tf32.f32 rounds it, small = x - big (exact in
    float32) as the tensor core reads it, its 13 low bits dropped.  big +
    small is within 2^-21 |x| of x, and a b = as bb + ab bs + ab bb keeps
    float32 accuracy."""
    big = _tf32(x)
    small = (x - big).contiguous().view(torch.int32) & -0x2000
    return big, small.view(torch.float32)


def tf32_split_nearest(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 x as the tensor-core chain of kernels 2 and
    3 splits it (csrc/tf32.cuh split_tf32_nearest): big = x rounded as
    cvt.rna.tf32.f32 rounds it, small = x - big rounded the same way."""
    big = tf32_split(x)[0]
    return big, tf32_split(x - big)[0]


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) as int32, -1000 for 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, -1000, e - 1)


def mma_tf32_model(c: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """c + a b as one mma.sync.m16n8k8 TF32 sums it on an H100: c (..., n,
    o) float32, a (..., n, 8) and b (..., 8, o) TF32 values, leading
    dimensions batched.  The 8 products are exact.  Each product's
    exponent is taken as the sum of its factors' (floor of log2 |x|);
    with E the largest of these and c's, each product and c is truncated
    toward zero to a multiple of 2^(E - 25), the terms are summed, and the
    sum is rounded to float32 toward zero.  Equal to the card's mma.sync
    bit for bit (scripts/mma_tf32_sums.py)."""
    e = (_exponent(a)[..., None] + _exponent(b)[..., None, :, :]).amax(-2)
    e = torch.maximum(e, _exponent(c)).clamp_min(-1000)
    q = torch.exp2((e - 25).double())
    p = a.double()[..., None] * b.double()[..., None, :, :]
    s = (torch.trunc(p / q[..., None, :]).sum(-2)
         + torch.trunc(c.double() / q)) * q
    f = s.float()
    return torch.where(f.double().abs() > s.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)
