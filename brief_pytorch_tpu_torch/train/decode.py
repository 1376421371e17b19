"""Dense grid inference (decompression).

Torch port of brief_pytorch_tpu/train/decode.py.  By default a supported
chain on a CUDA device decodes through the fused grid kernel
(ops/fused_decode.py); on the CPU the same function runs as the kernel's
plain version, in slabs of Decompress.sample_size voxels.  A model the
grid kernel does not support (see fused_decode.supports: res / skip /
encoder chains, the MFNs) runs its own apply over index_to_coords slabs on
either device.

With `half` (Compress.half) the slab loop runs model.apply in bfloat16
(compute_dtype) and the grid kernel is never used, as in JAX
(train/decode.py:61-71: the half decode keeps the training numerics).

With an `apply_fn` the slab loop runs that function instead, whatever the
model, and the grid kernel is not used: the explicit batch-major route,
for which `fused_apply_or` picks the fused forward kernel
(ops/fused_siren.py).  The slab route's coordinates are the affine
index_to_coords on every axis; the grid kernel's plane axes are
axis_linspace values, a float32 rounding apart (~1e-5 in decoded values).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import index_to_coords
from brief_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from brief_pytorch_tpu_torch.core.tree import tree_leaves
from brief_pytorch_tpu_torch.ops import fused_decode, fused_siren


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@torch.no_grad()
def reconstruct_flattened(model, params, data_shape: Sequence[int],
                          sample_size: int = 10000, coords_mode: str = "n11",
                          half: bool = False, *,
                          apply_fn: Optional[Callable] = None) -> np.ndarray:
    """Evaluate φ over the full voxel grid; returns (*spatial, c) float32.

    data_shape: (*spatial, data_channel) as stored in sideinfos.  The
    device is that of the parameters.  apply_fn(params, coords): None takes
    the default route (the grid kernel where it supports the model, else
    model.apply in slabs); a function is run over slabs of sample_size
    voxels (rounded up to a multiple of 128).  half: the default route is
    model.apply in bfloat16 over slabs.
    """
    *spatial, c = [int(s) for s in data_shape]
    pop = int(np.prod(spatial))
    slab = max(128, _round_up(min(sample_size, pop), 128))
    if apply_fn is None and not half and \
            fused_decode.supports(model, spatial):
        flat = fused_decode.decode_volume(model, params, spatial,
                                          coords_mode, slab=slab)
    else:
        if apply_fn is None:
            apply_fn = functools.partial(
                model.apply,
                compute_dtype=torch.bfloat16 if half else None)
        device = tree_leaves(params)[0].device
        flat = torch.cat([
            apply_fn(params, index_to_coords(
                torch.arange(s, min(pop, s + slab), device=device),
                spatial, coords_mode))
            for s in range(0, pop, slab)])
    return flat.cpu().numpy().astype(np.float32).reshape(*spatial, c)


def fused_apply_or(model, default_apply: Callable, use_kernel: bool = True,
                   device: DeviceLike = None) -> Callable:
    """The batch-major fused-chain apply for `model` (ops/fused_siren.py)
    when it is asked for, supports the model and `device` is a CUDA card;
    else `default_apply`.  device: None (the card; raises without one),
    'cpu', or a torch device, as at the other entry points.

    Not the decode default: grid decodes go through ops/fused_decode.py.
    This is for explicit batch-major use, e.g.
    reconstruct_flattened(..., apply_fn=fused_apply_or(model, model.apply)).
    """
    if not use_kernel or resolve_device(device).type != "cuda":
        return default_apply
    if fused_siren.supports(model):
        return fused_siren.make_fused_apply(model)
    return default_apply
