"""Crop pipeline for the NFLR (generalizable local INR) family.

Torch port of brief_pytorch_tpu/nflr/crop.py (reference utils/dataset.py:
64-195 crop_data / CroppedSampler / CropDataset, utils/misc.py:93-160
reconstruct_cropped, the path-list helpers of utils/io.py).

  * crop_data, _patch_starts and overlap_weights are numpy copies;
  * CroppedSampler draws the same np.random.default_rng(seed) permutation
    as the JAX package's, so both serve the same coordinates in the same
    order; the patch data goes to the sampler's device once and each batch
    is a gather there;
  * CropDataset shuffles its paths with a random.Random(seed) of its own
    (the JAX package uses the unseeded global `random`), so a run over
    several files, and its resume, is reproducible;
  * reconstruct_cropped decodes the patch grid on the device in chunks of
    sample_size and merges the overlaps on the host with the reference's
    centre-distance weights, in the JAX package's order (a deterministic
    sum: the decode of an archive is the same in every process).

Layouts follow the reference: batched volumes are channels-first
(n, c, d, h, w); cropped tensors are (n, pc_d, pc_h, pc_w, c, ps_d, ps_h,
ps_w).
"""
from __future__ import annotations

import math
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import axis_linspace
from brief_pytorch_tpu_torch.core.normalize import normalize_data
from brief_pytorch_tpu_torch.io.image import read_img


# ------------------------------------------------------------- io helpers --
def gen_pathlist_fromimgdir(data_dir: str) -> List[str]:
    """Sorted image paths in a directory (reference utils/io.py)."""
    names = sorted(os.listdir(data_dir))
    return [os.path.join(data_dir, n) for n in names
            if os.path.splitext(n)[-1].lower() in
            (".tif", ".tiff", ".png", ".jpg", ".mp4")]


def gen_data_path_list_list(data_dir: str, quantity: int = 1
                            ) -> List[List[str]]:
    """Group the dir's paths into batches of `quantity`."""
    paths = gen_pathlist_fromimgdir(data_dir)
    return [paths[i:i + quantity] for i in range(0, len(paths), quantity)]


def read_data_batch(path_list: List[str]) -> np.ndarray:
    """Stack volumes channels-first: (n, c, d, h, w)."""
    arr = np.stack([read_img(p) for p in path_list])     # (n, d, h, w, c)
    return np.moveaxis(arr, -1, 1)


def save_data_batch(data: np.ndarray, save_path_list: List[str]) -> None:
    from brief_pytorch_tpu_torch.io.image import save_img
    for i, path in enumerate(save_path_list):
        save_img(path, np.moveaxis(data[i], 0, -1))


def flattened_coords(shape: Sequence[int], device=None) -> torch.Tensor:
    """(prod(shape), len(shape)) row-major 'n11' coordinates of a patch."""
    axes = [axis_linspace(int(n), "n11", device=device) for n in shape]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grids, dim=-1).reshape(-1, len(shape))


# ------------------------------------------------------------- crop_data ---
def _patch_starts(n: int, ps: int, ol: int) -> Tuple[np.ndarray, int]:
    """Start offsets of overlapping patches; first pinned to 0, last pinned
    to n-ps (reference utils/dataset.py:76-96)."""
    pc = math.ceil((n - ol) / (ps - ol))
    starts = np.arange(pc) * (ps - ol)
    if pc > 1:
        starts[-1] = n - ps
    return starts, pc


def crop_data(data: np.ndarray, ps_h: int, ps_w: int, ol_h: int, ol_w: int,
              ps_d: Optional[int] = None, ol_d: Optional[int] = None
              ) -> Tuple[np.ndarray, tuple]:
    """(n, c, d, h, w) -> ((n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w),
    (pc_d, pc_h, pc_w)) — reference utils/dataset.py:64-100."""
    n, c, *spatial = data.shape
    if len(spatial) != 3:
        raise NotImplementedError(data.shape)
    d, h, w = spatial
    ds, pc_d = _patch_starts(d, ps_d, ol_d)
    hs, pc_h = _patch_starts(h, ps_h, ol_h)
    ws, pc_w = _patch_starts(w, ps_w, ol_w)
    out = np.zeros((n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w),
                   dtype=np.asarray(data).dtype)
    for di, d0 in enumerate(ds):
        for hi, h0 in enumerate(hs):
            for wi, w0 in enumerate(ws):
                out[:, di, hi, wi] = data[:, :, d0:d0 + ps_d, h0:h0 + ps_h,
                                          w0:w0 + ps_w]
    return out, (pc_d, pc_h, pc_w)


# --------------------------------------------------------- CroppedSampler --
class CroppedSampler:
    """Shuffled coordinate mini-batches over the patch population
    (reference utils/dataset.py:101-149).

    Yields (coords, values) on `device`: coords (n, *pc, k, 3) (a broadcast
    view), values (n, *pc, k, c).  The permutation is the JAX package's
    np.random.default_rng(seed) draw."""

    def __init__(self, cropped_data, sample_size: int, shuffle: bool = True,
                 seed: int = 0, device=None):
        if not isinstance(cropped_data, torch.Tensor):
            cropped_data = torch.from_numpy(np.asarray(cropped_data,
                                                       np.float32))
        cropped = cropped_data.float()
        assert cropped.ndim == 8, "3-D crops only (n,pc...,c,ps...)"
        self.device = cropped.device if device is None else \
            torch.device(device)
        n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w = cropped.shape
        self.ps = (ps_d, ps_h, ps_w)
        self.pop_size = ps_d * ps_h * ps_w
        self.sample_size = sample_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.coords_flat = flattened_coords(self.ps, self.device)
        # (n, pc_d, pc_h, pc_w, pop, c)
        self.data = torch.movedim(
            cropped.to(self.device).reshape(n, pc_d, pc_h, pc_w, c, -1),
            4, -1).contiguous()

    def __len__(self):
        return math.ceil(self.pop_size / self.sample_size)

    def __iter__(self):
        self.index = 0
        self.idxs = (self.rng.permutation(self.pop_size) if self.shuffle
                     else np.arange(self.pop_size))
        return self

    def __next__(self):
        if self.index >= len(self):
            raise StopIteration
        s = self.index * self.sample_size
        e = min(s + self.sample_size, self.pop_size)
        idx = torch.from_numpy(self.idxs[s:e]).to(self.device)
        self.index += 1
        coords = self.coords_flat[idx]                       # (k, 3)
        coords = coords.expand(self.data.shape[:4] + coords.shape)
        values = self.data.index_select(4, idx)
        return coords, values


# ------------------------------------------------------------ CropDataset --
class CropDataset:
    """Batch volumes -> normalize -> transform -> crop -> sampler
    (reference utils/dataset.py:150-195).  Yields (cropped, sampler,
    pc_shape, sideinfos) with cropped and the sampler's batches on
    `device`."""

    def __init__(self, batch_size: int, sample_size: int, Normalize_opt,
                 Transform_opt=None, crop_opt=None, shuffle_path: bool = True,
                 shuffle_sampler: bool = True, data_dir: Optional[str] = None,
                 data_path_list: Optional[List[str]] = None, seed: int = 0,
                 device=None):
        if (data_dir is not None) == (data_path_list is not None):
            raise ValueError("exactly one of data_dir/data_path_list")
        self.data_path_list = (gen_pathlist_fromimgdir(data_dir)
                               if data_dir else list(data_path_list))
        self.batch_size = batch_size
        self.sample_size = sample_size
        self.normalize_opt = dict(Normalize_opt)
        self.crop_opt = dict(crop_opt)
        self.shuffle_path = shuffle_path
        self.shuffle_sampler = shuffle_sampler
        self.seed = seed
        self.device = device
        self._draws = 0   # fresh sampler permutation per batch AND epoch
        self._path_rng = random.Random(seed)
        if Transform_opt is not None:
            from brief_pytorch_tpu_torch.nflr.transform import Transform
            self.transform = Transform.from_opt(Transform_opt)
        else:
            self.transform = lambda x: x

    def __len__(self):
        return math.ceil(len(self.data_path_list) / self.batch_size)

    def __iter__(self):
        if self.shuffle_path:
            self._path_rng.shuffle(self.data_path_list)
        self.index = 0
        return self

    def __next__(self):
        if self.index >= len(self):
            raise StopIteration
        s = self.index * self.batch_size
        e = min(s + self.batch_size, len(self.data_path_list))
        self.index += 1
        data = read_data_batch(self.data_path_list[s:e])
        data, sideinfos = normalize_data(data, **self.normalize_opt)
        data = self.transform(data)
        cropped, pc_shape = crop_data(data, **self.crop_opt)
        # a distinct sampler seed per draw, the JAX package's stream
        self._draws += 1
        cropped = torch.from_numpy(np.ascontiguousarray(
            cropped, np.float32)).to(self.device)
        sampler = CroppedSampler(cropped, self.sample_size,
                                 self.shuffle_sampler,
                                 self.seed + 1000003 * self._draws)
        sideinfos = {**sideinfos, "data_shape": list(data.shape)}
        return cropped, sampler, pc_shape, sideinfos


# --------------------------------------------------- reconstruct_cropped ---
def overlap_weights(ps: Tuple[int, int, int]) -> np.ndarray:
    """Centre-distance merge weights (reference utils/misc.py:125-135):
    weight(v) = |dist(v, centre) - max_dist| + 1 over the patch grid."""
    ps_d, ps_h, ps_w = ps
    zz, yy, xx = np.meshgrid(np.arange(ps_d), np.arange(ps_h),
                             np.arange(ps_w), indexing="ij")
    cz, cy, cx = ps_d // 2, ps_h // 2, ps_w // 2
    dist = np.sqrt((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2)
    return (np.abs(dist - dist.max()) + 1).astype(np.float32)


def merge_overlaps(cropped: np.ndarray, data_shape: Sequence[int],
                   ps_h: int, ps_w: int, ol_h: int, ol_w: int,
                   ps_d: Optional[int] = None, ol_d: Optional[int] = None,
                   **_) -> np.ndarray:
    """(n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w) patches -> the weighted
    (n, c, d, h, w) volume (reference utils/misc.py:136-160)."""
    n, c, d, h, w = [int(x) for x in data_shape]
    ds, _ = _patch_starts(d, ps_d, ol_d)
    hs, _ = _patch_starts(h, ps_h, ol_h)
    ws, _ = _patch_starts(w, ps_w, ol_w)
    wpatch = overlap_weights((ps_d, ps_h, ps_w))
    data = np.zeros((n, c, d, h, w), np.float32)
    weights = np.zeros((n, c, d, h, w), np.float32)
    for di, d0 in enumerate(ds):
        for hi, h0 in enumerate(hs):
            for wi, w0 in enumerate(ws):
                sl = (slice(None), slice(None), slice(d0, d0 + ps_d),
                      slice(h0, h0 + ps_h), slice(w0, w0 + ps_w))
                data[sl] += cropped[:, di, hi, wi] * wpatch
                weights[sl] += wpatch
    return data / weights


@torch.no_grad()
def reconstruct_cropped(data_shape: Sequence[int], sample_size: int, mods,
                        sample_nf, ps_h: int, ps_w: int, ol_h: int, ol_w: int,
                        ps_d: Optional[int] = None,
                        ol_d: Optional[int] = None, device=None, **_
                        ) -> np.ndarray:
    """Dense patchwise decode + weighted overlap merge
    (reference utils/misc.py:93-160).  Returns (n, c, d, h, w) float32."""
    n, c, d, h, w = [int(x) for x in data_shape]
    _, pc_d = _patch_starts(d, ps_d, ol_d)
    _, pc_h = _patch_starts(h, ps_h, ol_h)
    _, pc_w = _patch_starts(w, ps_w, ol_w)
    pop = ps_d * ps_h * ps_w
    coords_flat = flattened_coords((ps_d, ps_h, ps_w), device)
    chunks = []
    for s in range(0, pop, sample_size):
        e = min(s + sample_size, pop)
        coords = coords_flat[s:e].expand((n, pc_d, pc_h, pc_w, e - s, 3))
        chunks.append(sample_nf(coords, mods).float().cpu().numpy())
    cropped = np.concatenate(chunks, axis=-2)            # (n,*pc,pop,c)
    cropped = np.moveaxis(cropped, -1, 4).reshape(
        n, pc_d, pc_h, pc_w, c, ps_d, ps_h, ps_w)
    return merge_overlaps(cropped, data_shape, ps_h, ps_w, ol_h, ol_w,
                          ps_d, ol_d)
