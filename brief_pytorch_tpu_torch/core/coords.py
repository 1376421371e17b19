"""Coordinate-grid construction for implicit neural representations.

Coordinates are regenerated arithmetically from flat voxel indices rather
than gathered from a materialised (D*H*W, C) grid.  Torch port of
brief_pytorch_tpu/core/coords.py:20-68, bit-equal to it in float32
(tests/test_torch_coords.py).

Capability parity: reference `utils/dataset.py:11-62` (modes 'n11', '0p1',
"min,max").
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def parse_coords_mode(mode: str) -> Tuple[float, float]:
    """Parse a coords-mode string into (minimum, maximum).

    Accepts 'n11' (-1..1), '0p1' (0..1), or 'min,max' (e.g. '-1,1').
    """
    if mode == "n11":
        return -1.0, 1.0
    if mode == "0p1":
        return 0.0, 1.0
    lo, hi = mode.split(",")
    return float(lo), float(hi)


def axis_linspace(n: int, mode: str = "n11", dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """linspace(min, max, n) along one axis, endpoints inclusive; n == 1
    yields [min].

    Computed in float64 and rounded once to `dtype`.  jnp.linspace's
    float32 values come out of XLA's fused, FMA-contracted code and are not
    reproducible bit for bit; the two agree to four units in the last
    place of max(|min|, |max|) (tests/test_torch_coords.py)."""
    lo, hi = parse_coords_mode(mode)
    if n == 1:
        return torch.tensor([lo], dtype=dtype, device=device)
    return torch.linspace(lo, hi, n, dtype=torch.float64,
                          device=device).to(dtype)


def index_to_coords(flat_idx: torch.Tensor, shape: Sequence[int],
                    mode: str = "n11", dtype=torch.float32) -> torch.Tensor:
    """Map flat voxel indices -> coordinates, arithmetically (no grid gather).

    flat_idx: integer tensor of any shape; returns coords with trailing axis
    len(shape).  Row-major order matches the reference's
    rearrange('d h w c -> (d h w) c') flattening.  Each axis is the affine
    lo + i * step with step rounded to `dtype` first, as in the JAX package.
    """
    lo, hi = parse_coords_mode(mode)
    strides = []
    s = 1
    for n in reversed(shape):
        strides.append(s)
        s *= n
    strides = strides[::-1]
    comps = []
    for axis, n in enumerate(shape):
        idx_axis = torch.remainder(
            torch.div(flat_idx, strides[axis], rounding_mode="floor"), n)
        if n == 1:
            comps.append(torch.full(idx_axis.shape, lo, dtype=dtype,
                                    device=flat_idx.device))
        else:
            step = torch.tensor((hi - lo) / (n - 1), dtype=dtype,
                                device=flat_idx.device)
            comps.append(lo + idx_axis.to(dtype) * step)
    return torch.stack(comps, dim=-1)
