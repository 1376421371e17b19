"""Data parallelism: one network, the coordinate batch split over ranks.

Torch port of brief_pytorch_tpu/parallel/data_parallel.py.  The flattened
volume is padded to a multiple of the ranks and split into equal shards;
each rank keeps its shard on its device and draws its part of every
step's batch from it, with a generator of its own.  A step computes the
local (loss, gradients) with the single-volume trainer's step
(train/fit.py: the fused train kernel on a card where it supports the
chain, else autograd), then ONE all_reduce of a flat buffer holding every
gradient and the loss, divided by the ranks: the average over the union
batch, like the JAX package's one pmean.  Every rank then takes the same
Adamax step on the same reduced bits, so the parameters stay bitwise
replicated without a broadcast.

Config-reachable through `Compress.data_shards: N` (train/fit.py), which
needs a group of N ranks (parallel/mesh.py; the CLI starts one).  The
sampler must be randompoint with vector_len 1: the volume lives flattened
and sharded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from brief_pytorch_tpu_torch.core.coords import index_to_coords
from brief_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from brief_pytorch_tpu_torch.core.tree import tree_leaves, tree_unflatten
from brief_pytorch_tpu_torch.ops import fused_train
from brief_pytorch_tpu_torch.parallel import mesh
from brief_pytorch_tpu_torch.train.optim import make_optimizer


def pad_rows(arr: np.ndarray, m: int) -> np.ndarray:
    """arr (n, c) padded to a multiple of m rows with copies of row 0
    (JAX data_parallel.py:34-40)."""
    n = arr.shape[0]
    target = mesh.pad_to_multiple(n, m)
    if target == n:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], target - n, axis=0)])


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator: the run's seed with the rank
    folded in (JAX fold_in(key, rank))."""
    return int(seed) * 100003 + 7919 * (int(rank) + 1)


@dataclass(frozen=True)
class ShardSampler:
    """Uniform draws from one rank's shard of the flattened volume
    (JAX _dp_segment's loss_f): local_batch indices in [0, local_pop),
    their values from the shard, their coordinates from the global index
    rank * local_pop + i, where a padding row (global index past the
    volume) takes voxel 0's coordinates, as it holds voxel 0's value."""
    spatial_shape: Tuple[int, ...]
    coords_mode: str
    local_batch: int
    rank: int
    local_pop: int

    @staticmethod
    def generator_device(data_device: torch.device) -> torch.device:
        return data_device

    def sample_at(self, idx: torch.Tensor, data: torch.Tensor, weight):
        """(coords, values, weights) of the shard's rows `idx`."""
        vals = data[idx]
        wts = weight[idx] if weight is not None else torch.ones_like(vals)
        gidx = self.rank * self.local_pop + idx
        gidx = torch.where(gidx < int(np.prod(self.spatial_shape)), gidx, 0)
        return (index_to_coords(gidx, self.spatial_shape, self.coords_mode,
                                vals.dtype), vals, wts)

    def sample(self, gen: torch.Generator, data: torch.Tensor, weight):
        idx = torch.randint(0, self.local_pop, (self.local_batch,),
                            generator=gen, device=data.device)
        return self.sample_at(idx, data, weight)


class DataParallelTrainer:
    """Train ONE φ network with the coordinate batch split over the ranks
    of the process group (or `world` ranks given explicitly, for a rank's
    share without a group: shard_volume, global_batch)."""

    def __init__(self, model, seed: int = 42, device: DeviceLike = None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        self.model = model
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.rank = mesh.rank() if rank is None else int(rank)
        self.world = mesh.world() if world is None else int(world)
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of {self.world}")

    def shard_volume(self, data_norm: np.ndarray,
                     weight: Optional[np.ndarray]):
        """(*spatial, c) -> this rank's rows of the (pop, c) flattening
        padded to a multiple of the ranks, on the device: (data shard,
        weight shard or None, spatial shape).  Unit weights (or None) make
        no weight shard: nothing to move or keep for an all-ones volume."""
        spatial = tuple(int(s) for s in data_norm.shape[:-1])
        c = data_norm.shape[-1]
        flat = pad_rows(np.asarray(data_norm, np.float32).reshape(-1, c),
                        self.world)
        lp = flat.shape[0] // self.world
        own = slice(self.rank * lp, (self.rank + 1) * lp)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a[own])).to(
            self.device)
        if weight is None or bool(np.all(np.asarray(weight) == 1.0)):
            return to(flat), None, spatial
        wflat = pad_rows(np.asarray(weight, np.float32).reshape(-1, c),
                         self.world)
        return to(flat), to(wflat), spatial

    # ---------------------------------------------------- segment API -----
    def prepare(self, data_norm: np.ndarray, weight: Optional[np.ndarray],
                compress_cfg, weight_thres_norm: float, params):
        """Shard the volume once, make the optimizer, the shard sampler
        and this rank's generator; returns the optimizer state of `params`
        (which every rank inits alike, so they start replicated)."""
        cc = compress_cfg
        self._data, self._weight, spatial = self.shard_volume(data_norm,
                                                              weight)
        self._opt = make_optimizer(cc.optimizer_name_phi, float(cc.lr_phi),
                                   cc.lr_scheduler_phi)
        # ceil, not floor: the global batch is the smallest multiple of
        # the ranks >= sample_size (floor would drop up to world - 1
        # coordinates a step: 100,000 over 3 ranks would be 99,999)
        self._local_batch = max(1, -(-int(cc.sampler.sample_size)
                                     // self.world))
        self.sampler = ShardSampler(spatial, cc.coords_mode,
                                    self._local_batch, self.rank,
                                    self._data.shape[0])
        loss_name = cc.loss.name
        half = bool(cc.half)
        self.fused = bool(cc.get("fused_train", True)) \
            and self.device.type == "cuda" and not half \
            and fused_train.supports_training(self.model, loss_name)
        from brief_pytorch_tpu_torch.train.fit import NFGR
        self._grads = NFGR._fused_grads if self.fused else NFGR._autograd_grads
        self._kw = dict(model=self.model, loss_name=loss_name,
                        beta=float(cc.loss.get("beta", 0.01)),
                        weight_thres=float(weight_thres_norm))
        if not self.fused:
            self._kw["half"] = half
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(rank_seed(self.seed, self.rank))
        return self._opt.init(params)

    @property
    def global_batch(self) -> int:
        """Coordinates a step over all ranks (>= sample_size)."""
        return self._local_batch * self.world

    def step(self, params, opt_state, idx: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """One step on this rank's draw (or the shard rows `idx`): the
        local (loss, gradients), one all_reduce, the average, Adamax, in
        place.  Returns the loss averaged over the ranks."""
        batch = self.sampler.sample(self.gen, self._data, self._weight) \
            if idx is None else \
            self.sampler.sample_at(idx.to(self._data.device), self._data,
                                   self._weight)
        loss, grads = self._grads(params, *batch, **self._kw)
        leaves = tree_leaves(grads)
        flat = torch.cat([g.reshape(-1) for g in leaves]
                         + [loss.detach().reshape(1)])
        if self.world > 1:
            dist.all_reduce(flat)
            flat /= self.world
        sizes = [g.numel() for g in leaves]
        parts = torch.split(flat[:-1], sizes)
        grads = tree_unflatten(grads, [p.view_as(g) for p, g in
                                       zip(parts, leaves)])
        self._opt.step(params, grads, opt_state)
        return flat[-1]

    def run_steps(self, params, opt_state, n_steps: int,
                  draws: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
        """n_steps steps; draws: per step this rank's shard rows (tests
        inject them), else drawn.  Returns the (n_steps,) losses on the
        device."""
        losses: List[torch.Tensor] = []
        for i in range(n_steps):
            losses.append(self.step(params, opt_state,
                                    None if draws is None else draws[i]))
        return torch.stack(losses) if losses else torch.zeros(0)

    def fit(self, params, data_norm: np.ndarray, weight: np.ndarray,
            compress_cfg, n_steps: int, opt_state=None,
            weight_thres_norm: Optional[float] = None, draws=None):
        """Run n_steps; returns (params, opt_state, per-step losses as
        numpy).  weight_thres_norm: the threshold in data_norm's units
        (normalized as train/fit.py does); without it a non-zero
        cc.loss.weight_thres raises, since raw units would never match
        normalized predictions."""
        cc = compress_cfg
        if weight_thres_norm is None:
            if float(cc.loss.get("weight_thres", 0) or 0) != 0:
                raise ValueError(
                    "cc.loss.weight_thres is in raw dtype units but "
                    "data_norm is normalized; normalize the threshold like "
                    "fit.py does and pass weight_thres_norm explicitly")
            weight_thres_norm = 0.0
        fresh = self.prepare(data_norm, weight, cc, weight_thres_norm, params)
        if opt_state is None:
            opt_state = fresh
        losses = self.run_steps(params, opt_state, n_steps, draws)
        return params, opt_state, losses.cpu().numpy()
