"""Training samplers, drawing from an explicit torch.Generator.

Torch port of brief_pytorch_tpu/train/samplers.py (reference
main.py:38-163):
  * RandomPointSampler — sample_size uniform draws with replacement
    (vector_len 1), or sample_size / L runs of L consecutive voxels
    (vector_len L > 1); coordinates are regenerated arithmetically from
    the flat indices (core/coords.index_to_coords).  An integer volume
    (Compress.raw_gather) is gathered raw and dequantized after the
    gather.  The generator lives on the data's device, so a step never
    waits for the host.
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

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import index_to_coords


def device_raw(arr: np.ndarray, device) -> torch.Tensor:
    """An integer volume on `device` at its own width: uint16 as its int16
    bit pattern, since torch's CUDA gathers take no uint16 (raw_to_float
    reads it back)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(arr).to(device)


def raw_to_float(raw: torch.Tensor, uint16: bool) -> torch.Tensor:
    """Gathered raw integers -> float32; uint16: device_raw's int16 bit
    patterns of a uint16 volume."""
    x = raw.to(torch.int32)
    return (x & 0xFFFF if uint16 else x).to(torch.float32)


@dataclass(frozen=True)
class RandomPointSampler:
    """Uniform random voxel batches (reference RandompointSampler,
    main.py:126-163; JAX samplers.py:37-120).

    vector_len 1 draws sample_size independent voxels, the reference's
    iid draw.  vector_len L > 1 (Compress.sampler.vector_len) draws
    ceil(sample_size / L) runs of L voxels consecutive in flat order, cut
    to sample_size.  When L divides the population the runs are aligned
    rows of a (pop / L, L * c) view, one gathered row a run, and every
    voxel is equally likely; otherwise run starts are uniform on
    [0, pop - L] and expanded to voxel indices (the marginal is uniform
    except within L - 1 voxels of the ends).

    An integer data_flat (Compress.raw_gather, from device_raw) is
    gathered in its own width and turned into normalized float32 values
    after the gather, raw * dequant_scale + dequant_offset: the affine
    normalization the host applies, so the values agree with the float32
    gather to float32 rounding.  raw_uint16: data_flat holds a uint16
    volume's int16 bit patterns.
    """
    spatial_shape: Tuple[int, ...]   # (d, h, w) or (h, w)
    coords_mode: str
    sample_size: int
    vector_len: int = 1
    dequant_scale: float = 1.0       # used only for integer data_flat
    dequant_offset: float = 0.0
    raw_uint16: bool = False

    @staticmethod
    def generator_device(data_device: torch.device) -> torch.device:
        return data_device

    def _values(self, raw: torch.Tensor) -> torch.Tensor:
        """A gathered raw batch -> normalized float32 training values."""
        if raw.dtype.is_floating_point:
            return raw
        return raw_to_float(raw, self.raw_uint16) * self.dequant_scale \
            + self.dequant_offset

    def _coords(self, idx: torch.Tensor, data_flat: torch.Tensor):
        dtype = data_flat.dtype if data_flat.dtype.is_floating_point \
            else torch.float32
        return index_to_coords(idx, self.spatial_shape, self.coords_mode,
                               dtype)

    def sample_at(self, idx: torch.Tensor, data_flat: torch.Tensor,
                  weight_flat):
        """(coords, values, weights) of the flat voxel indices `idx`."""
        vals = self._values(data_flat[idx])
        wts = weight_flat[idx] if weight_flat is not None \
            else torch.ones_like(vals)
        return self._coords(idx, data_flat), vals, wts

    def n_runs(self) -> int:
        return -(-self.sample_size // self.vector_len)

    def run_indices(self, starts: torch.Tensor) -> torch.Tensor:
        """Flat voxel indices of runs of vector_len voxels at `starts`,
        run by run, cut to sample_size."""
        L = self.vector_len
        offs = torch.arange(L, device=starts.device)
        return (starts[:, None] + offs[None, :]).reshape(-1)[
            :self.sample_size]

    def sample_rows(self, rows: torch.Tensor, data_flat: torch.Tensor,
                    weight_flat):
        """(coords, values, weights) of the aligned runs `rows` (indices
        of the (pop / L, L * c) view): one gathered row a run."""
        L = self.vector_len
        pop, c = data_flat.shape
        take = lambda a: a.reshape(pop // L, L * c)[rows].reshape(-1, c)[
            :self.sample_size]
        vals = self._values(take(data_flat))
        wts = take(weight_flat) if weight_flat is not None \
            else torch.ones_like(vals)
        return self._coords(self.run_indices(rows * L), data_flat), vals, wts

    def sample(self, gen: torch.Generator, data_flat: torch.Tensor,
               weight_flat):
        """data_flat / weight_flat: (pop, c); weight_flat None means unit
        weights.  Returns (coords (S, ndim), values (S, c), weights (S, c))."""
        pop = data_flat.shape[0]
        L = int(self.vector_len)
        dev = data_flat.device
        if L <= 1:
            idx = torch.randint(0, pop, (self.sample_size,), generator=gen,
                                device=dev)
            return self.sample_at(idx, data_flat, weight_flat)
        if pop % L == 0:
            rows = torch.randint(0, pop // L, (self.n_runs(),),
                                 generator=gen, device=dev)
            return self.sample_rows(rows, data_flat, weight_flat)
        starts = torch.randint(0, max(1, pop - L + 1), (self.n_runs(),),
                               generator=gen, device=dev)
        return self.sample_at(self.run_indices(starts), data_flat,
                              weight_flat)


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
