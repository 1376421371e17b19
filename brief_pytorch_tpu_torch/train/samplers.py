"""Training samplers, drawing from an explicit torch.Generator.

Torch port of brief_pytorch_tpu/train/samplers.py (reference
main.py:38-163) for what the SingleTask path uses:
  * RandomPointSampler with vector_len=1 — sample_size uniform draws with
    replacement; coordinates are regenerated arithmetically from the drawn
    flat indices (core/coords.index_to_coords).  The generator lives on the
    data's device, so a step never waits for the host.
  * RandomCubeSampler — cube_count axis-aligned cubes from every stride-1
    position.  Corners are drawn on a CPU generator (the slice bounds are
    host integers); a cube that covers the whole volume has one position.
The draws differ from the JAX PRNG's; tests compare by injecting the same
indices and by distribution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from brief_pytorch_tpu_torch.core.coords import index_to_coords


@dataclass(frozen=True)
class RandomPointSampler:
    """Uniform random voxel batches (reference RandompointSampler,
    main.py:126-163).  Only vector_len=1, the reference's iid draw, is
    ported; the JAX package's contiguous-run option waits (ROADMAP.md)."""
    spatial_shape: Tuple[int, ...]   # (d, h, w) or (h, w)
    coords_mode: str
    sample_size: int

    @staticmethod
    def generator_device(data_device: torch.device) -> torch.device:
        return data_device

    def sample_at(self, idx: torch.Tensor, data_flat: torch.Tensor,
                  weight_flat):
        """(coords, values, weights) of the flat voxel indices `idx`."""
        vals = data_flat[idx]
        wts = weight_flat[idx] if weight_flat is not None \
            else torch.ones_like(vals)
        coords = index_to_coords(idx, self.spatial_shape, self.coords_mode,
                                 data_flat.dtype)
        return coords, vals, wts

    def sample(self, gen: torch.Generator, data_flat: torch.Tensor,
               weight_flat):
        """data_flat / weight_flat: (pop, c); weight_flat None means unit
        weights.  Returns (coords (S, ndim), values (S, c), weights (S, c))."""
        idx = torch.randint(0, data_flat.shape[0], (self.sample_size,),
                            generator=gen, device=data_flat.device)
        return self.sample_at(idx, data_flat, weight_flat)


@dataclass(frozen=True)
class RandomCubeSampler:
    """Random overlapping-cube batches (reference RandomCubeSampler,
    main.py:38-125).  Cubes are drawn from every stride-1 position."""
    spatial_shape: Tuple[int, ...]
    coords_mode: str
    cube_count: int
    cube_len: Tuple[int, ...]

    def __post_init__(self):
        clipped = tuple(min(c, s) for c, s in
                        zip(self.cube_len, self.spatial_shape))
        object.__setattr__(self, "cube_len", clipped)

    @staticmethod
    def generator_device(data_device: torch.device) -> torch.device:
        return torch.device("cpu")

    def sample_at(self, corners, data: torch.Tensor, weight):
        """(coords, values, weights) of the cubes at `corners`, a list of
        per-axis start indices, flattened cube by cube in row-major order."""
        ndim = len(self.spatial_shape)
        c = data.shape[-1]
        strides = [math.prod(self.spatial_shape[a + 1:]) for a in range(ndim)]
        local = torch.arange(math.prod(self.cube_len), device=data.device)
        coords, vals, wts = [], [], []
        for corner in corners:
            sl = tuple(slice(s, s + n) for s, n in zip(corner, self.cube_len))
            v = data[sl].reshape(-1, c)
            vals.append(v)
            wts.append(weight[sl].reshape(-1, c) if weight is not None
                       else torch.ones_like(v))
            flat = torch.zeros_like(local)
            rem = local
            for a in range(ndim - 1, -1, -1):
                n = self.cube_len[a]
                flat = flat + (torch.remainder(rem, n) + int(corner[a])) \
                    * strides[a]
                rem = torch.div(rem, n, rounding_mode="floor")
            coords.append(index_to_coords(flat, self.spatial_shape,
                                          self.coords_mode, data.dtype))
        if len(corners) == 1:
            return coords[0], vals[0], wts[0]
        return torch.cat(coords), torch.cat(vals), torch.cat(wts)

    def sample(self, gen: torch.Generator, data: torch.Tensor, weight):
        """data / weight: (*spatial_shape, c) (weight None: unit weights).
        Returns flattened (coords, values, weights) of
        cube_count * prod(cube_len) voxels."""
        ndim = len(self.spatial_shape)
        maxs = torch.tensor([s - n + 1 for s, n in
                             zip(self.spatial_shape, self.cube_len)])
        u = torch.rand((self.cube_count, ndim), generator=gen)
        corners = torch.floor(u * maxs).to(torch.int64).tolist()
        return self.sample_at(corners, data, weight)


def cube_size_guard(sampler_name: str, data_size: int, cube_voxels: int,
                    limit: int = 80 * 80 * 80) -> str:
    """Force randompoint when a cube exceeds the limit
    (reference main.py:332-334)."""
    if sampler_name == "randomcube" and min(data_size, cube_voxels) > limit:
        return "randompoint"
    return sampler_name
