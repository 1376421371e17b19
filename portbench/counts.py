"""The yardstick's arithmetic: the product operations and the bytes that a
call needs, from its shapes, and the least time the card could take for
them.

Only the matrix products are counted, at the networks' true widths (not
the kernels' padding), two operations a multiply-add; sines, biases and
other elementwise work are left out, and every input is counted read once
and every output written once.  So a share of the roofline can read low,
never above 100%, whatever computes the products at float32 accuracy.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

Dims = Sequence[Tuple[int, int]]        # (fan_in, fan_out) of each linear
F32 = 4


def peaks() -> Dict[str, float]:
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)


def macs(dims: Dims) -> int:
    """Multiply-adds of one forward pass through the chain, per point."""
    return sum(fi * fo for fi, fo in dims)


def param_floats(dims: Dims) -> int:
    return sum(fi * fo + fo for fi, fo in dims)


def train_step_flops(chains: List[Dims], points: int) -> float:
    """One training step of each chain on `points` coordinates: the forward
    pass, the weight gradients and the input gradients of every layer but
    the first (nothing needs the gradient of the coordinates)."""
    total = 0
    for dims in chains:
        total += 2 * macs(dims) + macs(dims[1:])
    return 2.0 * total * points


def train_step_bytes(chains: List[Dims], points: int) -> float:
    """Coordinates, values and weights read, parameters read and gradients
    and the loss written, per step."""
    total = 0
    for dims in chains:
        c_in, c_out = dims[0][0], dims[-1][1]
        total += points * (c_in + 2 * c_out) + 2 * param_floats(dims) + 1
    return float(total * F32)


def decode_flops(dims: Dims, voxels: int) -> float:
    """One forward pass over every voxel of the grid."""
    return 2.0 * macs(dims) * voxels


def decode_bytes(dims: Dims, voxels: int) -> float:
    """Parameters read and the float32 output written (the coordinates are
    made from the voxel index)."""
    return float((param_floats(dims) + voxels * dims[-1][1]) * F32)


def least_seconds(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    """The larger of the TF32 compute bound and the HBM bound."""
    return max(flops / pk["tf32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
