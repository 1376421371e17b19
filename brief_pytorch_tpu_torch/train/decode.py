"""Dense grid inference (decompression).

Torch port of brief_pytorch_tpu/train/decode.py:47-73.  A supported chain
on a CUDA device decodes through the fused grid kernel
(ops/fused_decode.py); on the CPU the same function runs as the kernel's
plain version, in slabs of Decompress.sample_size voxels.  A chain the
kernel does not support (see fused_decode.supports) runs the model's own
torch chain over index_to_coords slabs on either device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import index_to_coords
from brief_pytorch_tpu_torch.ops import fused_decode


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@torch.no_grad()
def reconstruct_flattened(model, params, data_shape: Sequence[int],
                          sample_size: int = 10000, coords_mode: str = "n11"
                          ) -> np.ndarray:
    """Evaluate φ over the full voxel grid; returns (*spatial, c) float32.

    data_shape: (*spatial, data_channel) as stored in sideinfos.  The
    device is that of the parameters.
    """
    *spatial, c = [int(s) for s in data_shape]
    slab = max(128, _round_up(min(sample_size, int(np.prod(spatial))), 128))
    if fused_decode.supports(model, spatial):
        flat = fused_decode.decode_volume(model, params, spatial,
                                          coords_mode, slab=slab)
    else:
        device = params["layers"][0]["w"].device
        pop = int(np.prod(spatial))
        flat = torch.cat([
            model.apply(params, index_to_coords(
                torch.arange(s, min(pop, s + slab), device=device),
                spatial, coords_mode))
            for s in range(0, pop, slab)])
    return flat.cpu().numpy().astype(np.float32).reshape(*spatial, c)
