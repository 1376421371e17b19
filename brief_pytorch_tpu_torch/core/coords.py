"""Coordinate-grid construction for implicit neural representations.

Coordinates are regenerated arithmetically from flat voxel indices rather
than gathered from a materialised (D*H*W, C) grid.  Torch port of
brief_pytorch_tpu/core/coords.py, bit-equal to it in float32
(tests/test_torch_coords.py) except where axis_linspace says otherwise.

Capability parity: reference `utils/dataset.py:11-62` (modes 'n11', '0p1',
"min,max").
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
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


# --------------------------------------------------------------------------
# per-block shapes (the block fleet, parallel/block_trainer.py)
# --------------------------------------------------------------------------
def row_major_strides(shape_vec: torch.Tensor) -> torch.Tensor:
    """Row-major voxel strides of a shape vector (..., ndim) (JAX
    core/coords.py:93-99), batched over leading axes."""
    rev = torch.cumprod(shape_vec.flip(-1), dim=-1).flip(-1)
    return torch.cat([rev[..., 1:], torch.ones_like(rev[..., :1])], dim=-1)


def axes_to_coords(axes_idx: torch.Tensor, shape_vec: torch.Tensor,
                   mode: str = "n11", dtype=torch.float32) -> torch.Tensor:
    """Per-axis integer indices (..., ndim) -> coordinates (JAX
    core/coords.py:102-112): lo + i * step with step = (hi - lo) / (n - 1)
    rounded to `dtype` (0 for axes of size 1).  shape_vec broadcasts
    against axes_idx: (ndim,) or (B, 1, ndim) for a batch of blocks."""
    lo, hi = parse_coords_mode(mode)
    n = shape_vec.to(dtype)
    step = torch.where(shape_vec > 1,
                       (hi - lo) / torch.clamp_min(n - 1.0, 1.0),
                       torch.zeros_like(n))
    return lo + axes_idx.to(dtype) * step


def floordiv24(a: torch.Tensor, b) -> torch.Tensor:
    """a // b for integer tensors (JAX core/coords.py:115-128).  The JAX
    package multiplies by a float32 reciprocal with two corrections, exact
    for 0 <= a < 2**24 and b >= 1; this divides integers, which is exact
    everywhere and equal to it there."""
    return torch.div(a, b, rounding_mode="floor")


def flat_to_axes24(flat_idx: torch.Tensor, shape_vec: torch.Tensor
                   ) -> torch.Tensor:
    """Flat row-major indices -> per-axis indices (..., ndim) (JAX
    core/coords.py:115-144).  The JAX package divides by a float32
    reciprocal with two corrections, exact for indices below 2**24; this
    divides integers, which is exact everywhere and equal to it there.
    shape_vec: (ndim,) or broadcastable to flat_idx's shape + (ndim,)."""
    ndim = shape_vec.shape[-1]
    rem = flat_idx
    axes = []
    for axis in range(ndim - 1, -1, -1):
        n = shape_vec[..., axis]
        axes.append(torch.remainder(rem, n))
        rem = torch.div(rem, n, rounding_mode="floor")
    return torch.stack(axes[::-1], dim=-1)


def index_to_coords_dynamic(flat_idx: torch.Tensor, shape_vec: torch.Tensor,
                            mode: str = "n11", dtype=torch.float32
                            ) -> torch.Tensor:
    """index_to_coords with a per-block shape vector (JAX
    core/coords.py:71-90); axes of size 1 map to the interval minimum."""
    lo, hi = parse_coords_mode(mode)
    ndim = shape_vec.shape[-1]
    comps = []
    rem = flat_idx
    for axis in range(ndim - 1, -1, -1):
        n = shape_vec[..., axis]
        idx_axis = torch.remainder(rem, n)
        rem = torch.div(rem, n, rounding_mode="floor")
        step = torch.where(
            n > 1, torch.tensor(hi - lo, dtype=dtype, device=n.device)
            / torch.clamp_min(n - 1, 1).to(dtype),
            torch.zeros((), dtype=dtype, device=n.device))
        comps.append(lo + idx_axis.to(dtype) * step)
    return torch.stack(comps[::-1], dim=-1)


# --------------------------------------------------------------------------
# dense grids
# --------------------------------------------------------------------------
def create_coords(shape: Sequence[int], mode: str = "n11",
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense coordinate grid of shape (*shape, len(shape)) (JAX
    core/coords.py:147-155; reference utils/dataset.py:11-35), each axis
    an axis_linspace."""
    axes = [axis_linspace(n, mode, dtype, device) for n in shape]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grids, dim=-1)


def create_flattened_coords(shape: Sequence[int], mode: str = "n11",
                            dtype=torch.float32, device=None
                            ) -> torch.Tensor:
    """Flat (prod(shape), len(shape)) coordinate list, row-major (JAX
    core/coords.py:158-164; reference utils/dataset.py:36-62)."""
    return create_coords(shape, mode, dtype, device).reshape(-1, len(shape))


def create_coords_np(shape: Sequence[int], mode: str = "n11") -> np.ndarray:
    """NumPy twin of create_coords for host-side code paths (a copy of
    JAX core/coords.py:167-173)."""
    lo, hi = parse_coords_mode(mode)
    axes = [np.linspace(lo, hi, n, dtype=np.float32) if n > 1
            else np.asarray([lo], dtype=np.float32) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack(grids, axis=-1)
