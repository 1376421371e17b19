"""Many blocks on one card: the DivideTask block fleet.

Torch port of brief_pytorch_tpu/parallel/block_trainer.py.  The reference
trains each block of a divided volume in its own process
(main.py:547-580); the fleet instead

  1. stacks B blocks' networks into leading-axis parameter tensors,
     padding heterogeneous widths (from alloc_param) up to the bucket
     maximum with masked units — padded units start at zero and get
     exactly zero gradient (their activations are masked to zero, so every
     gradient path through them vanishes), keeping the active
     sub-network's math that of unpadded training;
  2. runs each step for all B blocks at once: one batched draw, then the
     fused train kernel's fleet form (ops/fused_train.py, one launch per
     bucket per step) where `fleet_fused_supported` holds on a CUDA card,
     else autograd through the batched `stacked_apply`, as the JAX
     package's XLA path does; the optimizer (train/optim.py) updates the
     stacked tensors elementwise, which equals jax.vmap(tx.update);
  3. pads block voxel counts to a common Vmax and samples with per-block
     shapes, so adaptive blocking's uneven blocks share one program.

Compress.sampler.vector_len L > 1 draws runs of L voxels (JAX
block_trainer.py:491-546): with the voxel axis padded to a multiple of L,
aligned rows of L voxels inside each block's valid prefix; beyond 2^24
voxels, runs along the last axis.  L is clamped to the bucket's shortest
last axis.  Under Compress.raw_gather the stack keeps the raw integer
dtype and each gathered batch is dequantized with per-block (A, B)
(`dq_scale`, `dq_offset`).  `half` runs every product in bfloat16 with
float32 sums (models/phi.py compute_dtype) through autograd, never the
kernel, and decodes the same way.

Per-block semantics kept from the reference children: per-block
normalisation, byte budgets, loss means, threshold, Adamax + MultiStepLR
and the 80^3 cube guard on each block's own size.  Draws: randompoint
takes per-axis floor(u * S) (JAX block_trainer.py:547-566), randomcube
per-axis corners floor(u * (S - L + 1)) and the cube's voxels in row-major
order, fullbatch every voxel of the block (the cube covers it).  torch's
generator gives other numbers than JAX's PRNG; tests feed both the same u
and corners.

Chains with res entries, a skip concat or an encoder (res-SIREN, NeRF,
FFN with its stacked frozen bvals) stack like plain ones and train through
autograd, since `fleet_fused_supported` says no to them.  Families without
chain structure (MFNFourier, MFNGabor), and blocks whose `exception`
overrides step-level parameters (`solo_cfg`, parallel/divide_runner.py),
train on the solo path: one block at a time with the single-volume
trainer's sampler and step (train/fit.py) under the block's own Compress
node: its sampler, optimizer, lr and loss, and its own max_steps, which
the block reaches at the fleet's last checkpoint (each checkpoint advances
it to the proportional step, JAX block_trainer.py:1203-1232).  A plain
chain on the solo path trains on the fused train kernel's one-chain form
on the card, as NFGR trains it; an MFN block through autograd.

The fleet's whole training state (every bucket's and solo block's
parameters, optimizer state and generator, the solo blocks' steps) is
written at every checkpoint, and `train(..., resume_path=...)` continues
from it, bitwise equal to an uninterrupted run with the same checkpoint
grid (JAX block_trainer.py:792-913); its fingerprint records each solo
block's own step-level config.

More than one rank (a process group, parallel/mesh.py): `plan_fleet`
gives every block one rank, and each rank trains only its own: its rows
of a bucket (on the kernel's fleet form as on one rank) and its solo
blocks.  A bucket keeps the widths, voxel padding, vector_len, threshold
flag and draws of the whole bucket: each rank draws the whole bucket's
uniforms from the bucket's generator and keeps its rows, so a block's
draws do not depend on the number of ranks.  Checkpoints gather the
ranks' blocks (parameters, decodes, the training state) on the host;
rank 0 alone writes the state, which has the layout of a one-rank run,
and every rank reads its own rows back from it.
"""
from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import (axes_to_coords,
                                                 flat_to_axes24,
                                                 row_major_strides)
from brief_pytorch_tpu_torch.core.device import DeviceLike, resolve_device
from brief_pytorch_tpu_torch.core.tree import tree_leaves, tree_map
from brief_pytorch_tpu_torch.models.phi import (ChainSpec, PhiModel,
                                                _ChainModel, _act, encode)
from brief_pytorch_tpu_torch.ops import fused_train
from brief_pytorch_tpu_torch.parallel import mesh
from brief_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from brief_pytorch_tpu_torch.train.optim import make_optimizer
from brief_pytorch_tpu_torch.train.samplers import (RandomCubeSampler,
                                                    RandomPointSampler,
                                                    cube_size_guard,
                                                    device_raw, raw_to_float)


# --------------------------------------------------------------------------
# stacked masked chains
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class StackedChainSpec:
    """Common (padded) architecture of a bucket of chain networks.

    entries: per logical entry (kind, act, w0) — kind 'plain' consumes one
    linear from `dims`, kind 'res' (HalfResidual) consumes two.
    dims: padded (in, out) per linear, in entry order.
    """
    entries: Tuple[Tuple[str, str, float], ...]
    dims: Tuple[Tuple[int, int], ...]
    skip_entry: int = -1
    encoder: str = "none"     # 'none' | 'sirenpos' | 'nerf' | 'ffn'
    encoder_cfg: Tuple = ()

    @property
    def n_entries(self) -> int:
        return len(self.entries)


def _linear_dims(spec: ChainSpec) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of every linear in chain order (res entries own
    two linears, reference Networks.py:209-214, 251-257)."""
    out = []
    for e in spec.entries:
        out.append((e.fan_in, e.fan_out))
        if e.kind == "res":
            out.append((e.fan_out, e.fan_out))
    return out


def _stack_signature(spec: ChainSpec) -> tuple:
    """Everything two chain specs must share to be stack-padded together
    (only widths may differ; the first fan-in is the encoder's width)."""
    return (tuple((e.kind, e.act, e.w0, e.w_init) for e in spec.entries),
            spec.skip_entry, spec.encoder, tuple(spec.encoder_cfg),
            spec.entries[0].fan_in)


def _block_generator(seed: int, block: int) -> torch.Generator:
    """The init generator of block `block` of a fleet seeded `seed` (the
    JAX package folds the block index into its key)."""
    return torch.Generator().manual_seed(int(seed) * 100003 + int(block))


def build_stacked(models: Sequence[PhiModel], seed: int,
                  init_layers_list: Optional[Sequence] = None,
                  device: DeviceLike = "cpu"):
    """Stack B chain models (same family/topology, any widths) into padded
    leading-axis params + per-entry output masks.

    Each block draws its parameters with its own `model.init` (the init
    distributions of single-block training); init_layers_list entries
    ([{'w','b'},...] numpy, io.modelsave.load_model) warm-start blocks.

    Returns (stacked_spec, params, masks) where
      params["layers"][l] = {'w': (B, in_max, out_max), 'b': (B, out_max)}
      params["encoder"]   = the stacked frozen encoder parameters, for
                            'ffn' only: {'bvals': (B, embsize, c)}
      masks[e]            = (B, out_max_of_entry) float32 validity mask
    """
    sig0 = _stack_signature(models[0].spec)
    for m in models[1:]:
        if _stack_signature(m.spec) != sig0:
            raise ValueError("bucket mixes incompatible chain topologies")
    per_block, encoders = [], []
    for bi, m in enumerate(models):
        own = m.init(_block_generator(seed, bi))
        warm = init_layers_list[bi] if init_layers_list is not None else None
        if warm is not None:
            layers = [{k: np.asarray(v, np.float32) for k, v in l.items()}
                      for l in warm]
        else:
            layers = [{k: v.numpy() for k, v in l.items()}
                      for l in own["layers"]]
        per_block.append(layers)
        encoders.append(own.get("encoder"))
    lin_dims = [_linear_dims(m.spec) for m in models]
    spec0 = models[0].spec
    dims = [(max(d[l][0] for d in lin_dims), max(d[l][1] for d in lin_dims))
            for l in range(len(lin_dims[0]))]
    sspec = StackedChainSpec(
        entries=tuple((e.kind, e.act, e.w0) for e in spec0.entries),
        dims=tuple(dims), skip_entry=spec0.skip_entry,
        encoder=spec0.encoder, encoder_cfg=tuple(spec0.encoder_cfg))
    B = len(models)
    for bi, layers in enumerate(per_block):
        got = [tuple(l["w"].shape) for l in layers]
        if got != lin_dims[bi]:
            raise ValueError(f"block {bi}: warm-start weights of shapes {got} "
                             f"do not fit its network {lin_dims[bi]}")
    layers_np = []
    for l, (in_max, out_max) in enumerate(dims):
        w = np.zeros((B, in_max, out_max), np.float32)
        b = np.zeros((B, out_max), np.float32)
        for bi in range(B):
            fi, fo = lin_dims[bi][l]
            w[bi, :fi, :fo] = per_block[bi][l]["w"]
            b[bi, :fo] = per_block[bi][l]["b"]
        layers_np.append({"w": w, "b": b})
    masks_np = []
    li = 0
    for ei, e in enumerate(spec0.entries):
        li += 2 if e.kind == "res" else 1
        mk = np.zeros((B, dims[li - 1][1]), np.float32)
        for bi, m in enumerate(models):
            mk[bi, :m.spec.entries[ei].fan_out] = 1.0
        masks_np.append(mk)
    params, masks = stacked_from_numpy(layers_np, masks_np, device)
    if spec0.encoder == "ffn":
        params["encoder"] = {"bvals": torch.stack(
            [enc["bvals"] for enc in encoders]).to(params["layers"][0]["w"]
                                                   .device)}
    return sspec, params, masks


def stacked_from_numpy(layers, masks=None, device: DeviceLike = "cpu"):
    """The JAX fleet's stacked params ([{'w': (B, in, out), 'b': (B, out)}]
    as numpy) and masks ([(B, out)]) -> the port's float32 tensors on
    `device`: ({"layers": [...]}, [mask tensors])."""
    dev = torch.device(device) if isinstance(device, str) else device
    to = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    params = {"layers": [{k: to(v) for k, v in l.items()} for l in layers]}
    return params, [to(m) for m in (masks or [])]


def stacked_apply(layers, masks, coords: torch.Tensor,
                  spec: StackedChainSpec, enc: Optional[Dict] = None,
                  compute_dtype=None) -> torch.Tensor:
    """Batched forward of B padded chains: coords (B, N, C) -> (B, N, Cout).
    enc: the stacked frozen encoder parameters ('ffn': bvals (B, embsize,
    c)), which get no gradient.  compute_dtype: as in models/phi.py
    (`half`: bfloat16 products, float32 sums).

    Masking after each hidden entry's activation zeroes padded units,
    which keeps the active network exact (adding 0.0 terms to a float sum
    is exact) and kills every gradient path into padding.  The skip concat
    stays aligned because the encoder's width is topology-level (equal
    across the bucket) and valid hidden units are the leading columns of
    the padded block."""
    if spec.encoder == "ffn":
        enc = {"bvals": enc["bvals"].detach()}
    x = encode(coords, spec, enc, compute_dtype)
    h = x
    li = 0
    n_ent = spec.n_entries

    def rounded(t):     # compute_dtype's inputs, exact in float32
        return t if compute_dtype is None else \
            t.to(compute_dtype).to(torch.float32)

    def linear(h, layer):
        return torch.baddbmm(layer["b"][:, None, :], rounded(h),
                             rounded(layer["w"]))

    for ei, (kind, act, w0) in enumerate(spec.entries):
        if ei == spec.skip_entry:
            h = torch.cat([x, h], dim=-1)
        z = linear(h, layers[li])
        if kind == "plain":
            h = _act(act, w0, z)
            li += 1
        else:   # res: 0.5 * (sine(lin(sine(lin(h)))) + h)
            t = _act("sine", w0, z) * masks[ei][:, None, :]
            h = 0.5 * (_act("sine", w0, linear(t, layers[li + 1])) + h)
            li += 2
        if ei < n_ent - 1:
            h = h * masks[ei][:, None, :]
    return h


def unstack_params(params_layers, models: Sequence[PhiModel],
                   enc: Optional[Dict] = None) -> List[Dict]:
    """Slice each block's true-width layers out of the padded stack: per
    block {"layers": [{'w': (in, out), 'b': (out,)}]} of CPU tensors, with
    {"encoder": {"bvals"}} where the stack has one."""
    host = [{k: v.detach().cpu() for k, v in l.items()}
            for l in params_layers]
    out = []
    for bi, m in enumerate(models):
        p = {"layers": [
            {"w": host[l]["w"][bi, :fi, :fo].clone(),
             "b": host[l]["b"][bi, :fo].clone()}
            for l, (fi, fo) in enumerate(_linear_dims(m.spec))]}
        if enc and "bvals" in enc:
            p["encoder"] = {"bvals": enc["bvals"][bi].detach().cpu().clone()}
        out.append(p)
    return out


# --------------------------------------------------------------------------
# block batch container
# --------------------------------------------------------------------------
@dataclass
class BlockBatch:
    """B normalised blocks padded to a common flat voxel count (host
    numpy; the trainer moves them to the card)."""
    data: np.ndarray           # (B, Vmax, c) float32, or the raw integer
    #                            dtype when dq_scale is set (see build)
    weight: np.ndarray         # (B, Vmax, c) float32
    valid: np.ndarray          # (B,) int64 true voxel counts
    shapes: np.ndarray         # (B, ndim) int64 spatial extents
    vmax: int
    ndim: int
    dq_scale: Optional[np.ndarray] = None    # (B,) float32 (integer stacks)
    dq_offset: Optional[np.ndarray] = None

    @staticmethod
    def build(blocks: List[Dict], pad_multiple: int = 1,
              rows: Optional[Sequence[int]] = None) -> "BlockBatch":
        """blocks: dicts with 'data_norm' (*spatial, c) float32 and
        'weight' of the same shape; Vmax is padded to a multiple of
        pad_multiple (the aligned vector_len gather needs Vmax % L == 0).
        rows: stack only these blocks (a rank's share of a bucket), with
        Vmax and the dtype of all of them.

        When every block also carries 'data_raw' (its preprocessed
        integer chunk) and 'dequant' ((A, B) with data_norm == raw * A +
        B, parallel/divide_runner.py), all of one dtype, the stack keeps
        that raw dtype and the draws dequantize each gathered batch (JAX
        block_trainer.py:281-332)."""
        ndim = blocks[0]["data_norm"].ndim - 1
        c = blocks[0]["data_norm"].shape[-1]
        vmax = max(int(np.prod(b["data_norm"].shape[:-1])) for b in blocks)
        vmax = -(-vmax // pad_multiple) * pad_multiple
        raw = all(b.get("dequant") is not None and
                  b.get("data_raw") is not None for b in blocks) and \
            len({b["data_raw"].dtype for b in blocks}) == 1
        dtype = blocks[0]["data_raw"].dtype if raw else np.float32
        if rows is not None:
            blocks = [blocks[i] for i in rows]
        B = len(blocks)
        dq_scale = dq_offset = None
        data = np.zeros((B, vmax, c), dtype)
        if raw:
            dq_scale = np.asarray([b["dequant"][0] for b in blocks],
                                  np.float32)
            dq_offset = np.asarray([b["dequant"][1] for b in blocks],
                                   np.float32)
        weight = np.zeros((B, vmax, c), np.float32)
        valid = np.zeros((B,), np.int64)
        shapes = np.ones((B, ndim), np.int64)
        for i, b in enumerate(blocks):
            v = int(np.prod(b["data_norm"].shape[:-1]))
            data[i, :v] = (b["data_raw"] if raw else
                           b["data_norm"]).reshape(v, c)
            weight[i, :v] = b["weight"].reshape(v, c)
            valid[i] = v
            shapes[i] = b["data_norm"].shape[:-1]
        return BlockBatch(data, weight, valid, shapes, vmax, ndim, dq_scale,
                          dq_offset)


# --------------------------------------------------------------------------
# fleet draws (batched over the block axis)
# --------------------------------------------------------------------------
ALIGNED_LIMIT = 1 << 24   # flat_to_axes24 is exact below it


def point_axes(u: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
    """randompoint: per-axis voxel indices min(floor(u * S), S - 1) of
    uniform u (B, S, ndim) in [0, 1) for blocks of shapes (B, ndim)."""
    s = shapes[:, None, :]
    return torch.minimum((u * s.to(u.dtype)).to(torch.int64), s - 1)


def vector_rows(u: torch.Tensor, valid: torch.Tensor, L: int
                ) -> torch.Tensor:
    """randompoint, vector_len L, aligned form: the rows (B, n_runs) of L
    voxels min(floor(u * R), R - 1), R = max(valid // L, 1), of uniform u
    (B, n_runs): rows inside each block's valid prefix (a block's last
    valid % L voxels are never drawn, as in JAX block_trainer.py:491-524)."""
    rows = torch.clamp_min(valid // L, 1)[:, None]
    return torch.minimum((u * rows.to(u.dtype)).to(torch.int64), rows - 1)


def vector_run_starts(u: torch.Tensor, shapes: torch.Tensor, L: int
                      ) -> torch.Tensor:
    """randompoint, vector_len L, row-contained form: per-axis starts
    (B, n_runs, ndim) of uniform u (B, n_runs, ndim) for runs of L voxels
    along the last axis, min(floor(u * lim), lim - 1) with lim = S less
    L - 1 on the last axis (JAX vector_run_starts, block_trainer.py:357)."""
    ndim = shapes.shape[1]
    cut = torch.zeros(ndim, dtype=shapes.dtype, device=shapes.device)
    cut[-1] = L - 1
    lim = (shapes - cut)[:, None, :]
    return torch.minimum((u * lim.to(u.dtype)).to(torch.int64), lim - 1)


def cube_corners(u: torch.Tensor, shapes: torch.Tensor,
                 cube_len: Sequence[int]) -> torch.Tensor:
    """randomcube: per-axis corners (B, cube_count, ndim) of uniform u
    (B, cube_count, ndim): floor(u * (S - L + 1)), every stride-1
    position equally likely."""
    maxs = (shapes - torch.as_tensor(cube_len, device=shapes.device)
            + 1)[:, None, :]
    return torch.minimum((u * maxs.to(u.dtype)).to(torch.int64), maxs - 1)


def cube_positions(corners: torch.Tensor, cube_len: Sequence[int]
                   ) -> torch.Tensor:
    """Per-axis voxel positions (B, cube_count, prod(cube_len), ndim) of
    the cubes at `corners`, each cube's voxels in row-major order (the
    voxel order of RandomCubeSampler's slice + reshape)."""
    axes = [torch.arange(n, device=corners.device) for n in cube_len]
    offs = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(-1, len(cube_len))
    return corners[:, :, None, :] + offs[None, None]


def cube_gather_indices(corners: torch.Tensor, shapes: torch.Tensor,
                        cube_len: Sequence[int]) -> torch.Tensor:
    """Flat voxel indices (B, cube_count * prod(cube_len)) of the cubes at
    `corners` (row-major flattening of cube_positions)."""
    pos = cube_positions(corners, cube_len)
    strides = row_major_strides(shapes)[:, None, None, :]
    return (pos * strides).sum(-1).reshape(corners.shape[0], -1)


def _take(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack (B, Vmax, c)[b, idx[b]] -> (B, S, c) (advanced indexing,
    which takes the raw integer stacks too)."""
    b = torch.arange(stack.shape[0], device=stack.device)[:, None]
    return stack[b, idx]


def vector_form(sampler: str, vector_len: int, vmax: int) -> str:
    """The draw a bucket takes: 'aligned' or 'runs' for randompoint with
    vector_len > 1 (aligned rows when L divides Vmax and Vmax <= 2^24,
    JAX block_trainer.py:491), else the sampler's own."""
    if sampler != "randompoint" or vector_len <= 1:
        return sampler
    return "aligned" if vmax % vector_len == 0 and vmax <= ALIGNED_LIMIT \
        else "runs"


def draw_uniform(form: str, gen: torch.Generator, B: int, ndim: int, *,
                 sample_size: int, cube_count: int = 1, vector_len: int = 1,
                 device=None) -> Optional[torch.Tensor]:
    """The uniform draws of one step of a bucket drawn in `form`
    (vector_form), on gen: what draw_batch turns into a batch."""
    n_runs = -(-sample_size // vector_len)
    shape = {"randomcube": (B, cube_count, ndim),
             "randompoint": (B, sample_size, ndim),
             "aligned": (B, n_runs),
             "runs": (B, n_runs, ndim)}.get(form)
    if shape is None:
        if form != "fullbatch":
            raise NotImplementedError(form)
        return None
    return torch.rand(shape, generator=gen, device=device)


def draw_batch(sampler: str, gen: Optional[torch.Generator],
               data: torch.Tensor, weight: Optional[torch.Tensor],
               valid: torch.Tensor, shapes: torch.Tensor, coords_mode: str,
               *, sample_size: int, cube_count: int = 1,
               cube_len: Sequence[int] = (), vector_len: int = 1,
               dq_scale: Optional[torch.Tensor] = None,
               dq_offset: Optional[torch.Tensor] = None,
               raw_uint16: bool = False,
               u: Optional[torch.Tensor] = None):
    """One step's batch for every block of a bucket, in one batched call:
    (coords (B, S, ndim), values (B, S, c), weights (B, S, c),
    sample_valid (B, S, 1) or None).  u: the step's uniform draws
    (draw_uniform), drawn on gen when None.  An integer stack (device_raw;
    raw_uint16: a uint16 one's int16 bit patterns) is dequantized per
    block, values * dq_scale + dq_offset."""
    B, vmax, c = data.shape
    ndim = shapes.shape[1]
    form = vector_form(sampler, vector_len, vmax)
    if u is None:
        u = draw_uniform(form, gen, B, ndim, sample_size=sample_size,
                         cube_count=cube_count, vector_len=vector_len,
                         device=data.device)
    sample_valid = None
    if form == "fullbatch":
        idx = torch.arange(vmax, device=data.device).expand(B, vmax)
        axes = flat_to_axes24(idx, shapes[:, None, :])
        sample_valid = (idx < valid[:, None])[..., None].to(torch.float32)
        vals, wts = data, weight
    elif form == "aligned":
        L = vector_len
        rows = vector_rows(u, valid, L)
        idx = (rows[:, :, None] * L + torch.arange(L, device=data.device)
               ).reshape(B, -1)[:, :sample_size]
        row_take = lambda a: _take(a.reshape(B, vmax // L, L * c),
                                   rows).reshape(B, -1, c)[:, :sample_size]
        vals = row_take(data)
        wts = None if weight is None else row_take(weight)
        axes = flat_to_axes24(idx, shapes[:, None, :])
    else:
        if form == "randomcube":
            axes = cube_positions(cube_corners(u, shapes, cube_len),
                                  cube_len).reshape(B, -1, ndim)
        elif form == "runs":
            L = vector_len
            offs = torch.zeros((L, ndim), dtype=torch.int64,
                               device=data.device)
            offs[:, -1] = torch.arange(L, device=data.device)
            axes = (vector_run_starts(u, shapes, L)[:, :, None, :]
                    + offs).reshape(B, -1, ndim)[:, :sample_size]
        else:
            axes = point_axes(u, shapes)
        idx = (axes * row_major_strides(shapes)[:, None, :]).sum(-1)
        vals = _take(data, idx)
        wts = None if weight is None else _take(weight, idx)
    if not vals.dtype.is_floating_point:
        vals = raw_to_float(vals, raw_uint16) * dq_scale[:, None, None] \
            + dq_offset[:, None, None]
    if wts is None:
        wts = torch.ones_like(vals)
    coords = axes_to_coords(axes, shapes[:, None, :], coords_mode)
    return coords, vals, wts, sample_valid


def fleet_fused_supported(spec: StackedChainSpec, loss_name: str,
                          sampler_name: str, half: bool) -> bool:
    """Whether the fused train kernel's fleet form can run a stacked bucket
    (JAX block_trainer.py:387-401): plain f32 activation chains (no
    encoder/skip/res), the two kernel losses, and a sampler that yields
    all-valid batches (fullbatch needs the per-block valid-voxel mask the
    kernel does not take)."""
    return (not half
            and loss_name in fused_train.LOSSES
            and sampler_name != "fullbatch"
            and spec.encoder == "none"
            and spec.skip_entry < 0
            and all(k == "plain" and a in ("sine", "relu", "sigmoid", "none")
                    for k, a, _ in spec.entries))


def _elem_loss(loss_name: str, beta: float, pred, vals):
    if loss_name == "datal2":
        return (pred - vals) ** 2
    if loss_name == "datasmoothl1":
        d = (pred - vals).abs()
        return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    raise NotImplementedError(loss_name)


# --------------------------------------------------------------------------
# bucket state and the step loop
# --------------------------------------------------------------------------
@dataclass
class _BucketState:
    """Live training state of one stacked bucket: the rows this rank
    trains (all of them on one rank)."""
    block_idxs: List[int]          # the bucket's indices into the block list
    rows: List[int]                # this rank's positions in block_idxs
    models: List                   # the bucket's models
    spec: StackedChainSpec
    params: Dict                   # {"layers": [{'w': (B,..), 'b': (B,..)}]}
    opt_state: Dict
    masks: List[torch.Tensor]
    batch: BlockBatch
    data: torch.Tensor
    weight: Optional[torch.Tensor]
    valid: torch.Tensor
    shapes: torch.Tensor
    opt: object
    gen: torch.Generator
    thres: torch.Tensor            # (B,) per-block normalized thresholds
    use_thres: bool = True
    sampler_name: str = "randompoint"  # effective: randompoint|randomcube|fullbatch
    cube_len: Tuple[int, ...] = ()     # clipped, static per bucket
    vector_len: int = 1                # clamped to the bucket's min last axis
    dq_scale: Optional[torch.Tensor] = None   # (B,) integer stacks
    dq_offset: Optional[torch.Tensor] = None
    half: bool = False
    fused: bool = False
    occupancy: float = 1.0         # real voxels / the bucket's padded grid
    losses: Optional[torch.Tensor] = None   # (steps, rows) of the last segment

    @property
    def own_idxs(self) -> List[int]:
        """This rank's blocks, as indices into the fleet's block list."""
        return [self.block_idxs[r] for r in self.rows]

    @property
    def own_models(self) -> List:
        return [self.models[r] for r in self.rows]


@dataclass
class _SoloState:
    """Training state of a block that trains alone: a φ family without
    chain structure (the MFNs' multiplicative filters), or a block whose
    `exception` overrides step-level parameters.  It trains with the
    single-volume trainer's sampler and step under its own Compress node
    `cc` — what one reference child process did (main.py:277-280,
    568-569)."""
    slot: int                      # its place among the fleet's solo blocks
    block_idx: int
    model: object
    params: Dict
    opt_state: Dict
    opt: object
    gen: torch.Generator
    sampler: object
    data: torch.Tensor
    weight: Optional[torch.Tensor]
    thres: float
    cc: object = None              # this block's effective Compress node
    total_steps: int = 0           # its own max_steps
    fused: bool = False            # the one-chain train kernel
    steps_done: int = 0
    losses: Optional[torch.Tensor] = None   # (steps,) of the last segment


def fleet_step(st: _BucketState, coords, vals, wts, sample_valid, *,
               loss_name: str, beta: float):
    """(losses (B,), grads) of one step of a bucket on a drawn batch: the
    fused train kernel's fleet form, or autograd through stacked_apply
    (bfloat16 products under `half`)."""
    layers = st.params["layers"]
    thres = st.thres if st.use_thres else None
    if st.fused:
        acts = tuple((a, float(w0)) for _, a, w0 in st.spec.entries)
        unit_masks = list(st.masks[:-1]) + [None]   # the output is unmasked
        return fused_train.fused_train_grads_fleet(
            layers, coords.transpose(1, 2).contiguous(),
            vals.transpose(1, 2).contiguous(),
            wts.transpose(1, 2).contiguous(), acts, loss_name=loss_name,
            beta=beta, unit_masks=unit_masks, thres=thres)
    leaves = tree_leaves({"layers": layers})
    for t in leaves:
        t.requires_grad_(True)
    try:
        pred = stacked_apply(layers, st.masks, coords, st.spec,
                             st.params.get("encoder"),
                             torch.bfloat16 if st.half else None)
        if thres is not None:
            wts = torch.where(pred <= thres[:, None, None], 1.0, wts)
        err = _elem_loss(loss_name, beta, pred, vals) * wts
        if sample_valid is None:
            loss = err.mean(dim=(1, 2))
        else:   # full batch: mean over each block's valid voxels
            loss = (err * sample_valid).sum(dim=(1, 2)) / \
                torch.clamp_min(st.valid.to(err.dtype), 1.0)
        flat = torch.autograd.grad(loss.sum(), leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(flat)
    return loss.detach(), {"layers": [{k: next(it) for k in l}
                                      for l in layers]}


def run_block_segment(st: _BucketState, n_steps: int, *, loss_name: str,
                      beta: float, sample_size: int, coords_mode: str,
                      cube_count: int = 1) -> torch.Tensor:
    """n_steps of simultaneous training for all B blocks of a bucket
    (JAX block_trainer.py:404-631 as a step loop), of this rank's rows.
    Updates st.params and st.opt_state in place; returns the losses
    (n_steps, rows) on the device without waiting for it."""
    if not st.rows:
        return torch.zeros((n_steps, 0), device=st.data.device)
    trained = {"layers": st.params["layers"]}   # the frozen encoder is not
    losses = []                                 # stepped
    form = vector_form(st.sampler_name, st.vector_len, st.batch.vmax)
    size = len(st.block_idxs)
    for _ in range(n_steps):
        # the whole bucket's draws, this rank's rows of them
        u = draw_uniform(form, st.gen, size, st.batch.ndim,
                         sample_size=sample_size, cube_count=cube_count,
                         vector_len=st.vector_len, device=st.data.device)
        if u is not None and len(st.rows) < size:
            u = u[st.rows]
        batch = draw_batch(
            st.sampler_name, st.gen, st.data, st.weight, st.valid, st.shapes,
            coords_mode, sample_size=sample_size, cube_count=cube_count,
            cube_len=st.cube_len, vector_len=st.vector_len,
            dq_scale=st.dq_scale, dq_offset=st.dq_offset,
            raw_uint16=st.batch.data.dtype == np.uint16, u=u)
        loss, grads = fleet_step(st, *batch, loss_name=loss_name, beta=beta)
        st.opt.step(trained, grads, st.opt_state)
        losses.append(loss)
    return torch.stack(losses)


@torch.no_grad()
def decode_blocks(params_layers, masks, shapes: torch.Tensor,
                  spec: StackedChainSpec, *, slab: int, coords_mode: str,
                  vmax: int, enc: Optional[Dict] = None,
                  half: bool = False) -> torch.Tensor:
    """Batched padded grid decode: (B, Vmax, c) predictions, slab by slab
    of flat indices, coordinates from affine per-block formulas (JAX
    block_trainer.py:634-661); bfloat16 products under `half`."""
    out = []
    for s in range(0, vmax, slab):
        idx = torch.arange(s, min(vmax, s + slab), device=shapes.device)
        axes = flat_to_axes24(idx[None, :], shapes[:, None, :])
        coords = axes_to_coords(axes, shapes[:, None, :], coords_mode)
        out.append(stacked_apply(params_layers, masks, coords, spec, enc,
                                 torch.bfloat16 if half else None))
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------------
# the fleet
# --------------------------------------------------------------------------
def step_config(cc) -> Dict:
    """The step-level parameters of a Compress node that a stacked bucket
    shares and an `exception` may override, as plain values: a block
    whose values differ from the fleet's trains solo
    (parallel/divide_runner.py)."""
    return {"sampler": cc.sampler.to_plain(),
            "max_steps": int(cc.get("max_steps", 0)),
            "lr": float(cc.lr_phi), "optimizer": str(cc.optimizer_name_phi),
            "scheduler": cc.lr_scheduler_phi.to_plain(),
            "loss": f"{cc.loss.name}/{float(cc.loss.get('beta', 0.01))}",
            "half": bool(cc.half), "coords_mode": str(cc.coords_mode)}


def _solo_config(blk: Dict, cc, fleet_max_steps: int, device) -> Tuple:
    """(Compress node, on the one-chain train kernel, max_steps) of a solo
    block: its own node (`solo_cfg`) or the fleet's; a plain chain on a
    card trains on the kernel, as NFGR trains it."""
    scc = blk.get("solo_cfg") or cc
    fused = bool(scc.get("fused_train", True)) and device.type == "cuda" \
        and not bool(scc.half) \
        and fused_train.supports_training(blk["model"], scc.loss.name)
    total = int(scc.get("max_steps", fleet_max_steps)) \
        if blk.get("solo_cfg") else fleet_max_steps
    return scc, fused, total


def _host_tree(tree):
    """A tree of tensors as a tree of numpy arrays (what ranks gather)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _merge_rows(trees: Sequence, rows: Sequence[Sequence[int]]):
    """Trees of (len(rows[k]), ...) arrays from each rank -> one tree of
    the whole bucket's arrays, each rank's rows at their positions."""
    order = np.argsort(np.concatenate([np.asarray(r, np.int64)
                                       for r in rows]))
    return tree_map(lambda *leaves: np.concatenate(leaves)[order], *trees)


class BlockFleetTrainer:
    """Trains a fleet of per-block INRs as stacked buckets on one card, or
    on each rank of a process group its own blocks.

    Buckets group blocks by (phi family, topology, effective sampler);
    widths inside a bucket are padded to the max.  Blocks that do not stack
    (the MFN families) train on the solo path, one after another.  Buckets
    and solo blocks advance in lockstep between checkpoints, so a
    checkpoint callback sees the whole fleet at one step, as the
    reference's children all checkpoint at the same step numbers
    (main.py:585-607).  Segments are queued without waiting for the card;
    the one sync per checkpoint interval is the fetch of the last losses.
    On several ranks every rank calls train() alike: its checkpoints are
    collectives (the fleet's parameters, its decode and its state are
    gathered on the host), and every rank reaches each callback.
    """

    def __init__(self, seed: int = 42, device: DeviceLike = None):
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._states: List[_BucketState] = []
        self._solo: List[_SoloState] = []       # this rank's solo blocks
        self._solo_idxs: List[int] = []         # every solo block
        self.train_s = 0.0           # host seconds in the training steps
        # the last step's losses: per bucket (B,), then per solo block (1,)
        # that has stepped; _solo_losses by its place among the solo blocks
        self.last_losses: List[np.ndarray] = []
        self._solo_losses: Dict[int, np.ndarray] = {}

    def train(self, blocks: List[Dict], compress_cfg, max_steps: int,
              checkpoint_cb=None, checkpoints: Optional[List[int]] = None,
              progress_cb=None, state_path: Optional[str] = None,
              resume_path: Optional[str] = None) -> List[Dict]:
        """blocks: dicts with keys data_norm, weight, model (PhiModel),
        name, weight_thres_norm.  Returns blocks with 'params' attached
        (every block's, on every rank).

        compress_cfg: the Compress config node (sampler, loss, lr, ...).
        checkpoint_cb(step, blocks, per_block_params) fires at every entry
        of `checkpoints` with the whole fleet.  progress_cb(step, losses)
        fires at every checkpoint that trained steps, before checkpoint_cb,
        on every rank: losses is a float array of every block's last loss
        in block order, NaN for a solo block whose schedule has not reached
        its first step (JAX block_trainer.py:867-885); it reads the losses
        the checkpoint already fetched.  state_path: write the
        fleet's training state (stacked params, optimizer states,
        generator states) there at every checkpoint, atomically (rank 0).
        resume_path: a state file (or a run dir holding
        trainstate_fleet.npz) written so under the same config; training
        continues from its step, and checkpoints up to it are skipped."""
        cc = compress_cfg
        buckets: Dict[tuple, List[int]] = {}
        solo_idxs: List[int] = []
        for i, blk in enumerate(blocks):
            m = blk["model"]
            # a block whose exception overrides step-level parameters
            # trains solo under its own Compress node (main.py:568-569)
            blk_cc = blk.get("solo_cfg") or cc
            # the reference's 80^3 cube guard, on each block's own size
            shape = blk["data_norm"].shape[:-1]
            clipped = tuple(min(int(c), s) for c, s in
                            zip(blk_cc.sampler.cube_len, shape))
            eff = cube_size_guard(blk_cc.sampler.name, int(np.prod(shape)),
                                  int(np.prod(clipped)))
            blk["sampler_name"] = eff
            if not isinstance(m, _ChainModel) or blk.get("solo_cfg"):
                solo_idxs.append(i)
                continue
            sig = (type(m).__name__, _stack_signature(m.spec), eff,
                   clipped if eff == "randomcube" else ())
            buckets.setdefault(sig, []).append(i)
        rank = mesh.rank()
        bucket_ranks, solo_ranks = mesh.plan_fleet(
            [len(v) for v in buckets.values()], len(solo_idxs), mesh.world())
        self._states = [
            self._prepare_bucket(blocks, idxs, cc,
                                 [j for j, r in enumerate(ranks) if r == rank])
            for idxs, ranks in zip(buckets.values(), bucket_ranks)]
        self._solo_idxs = solo_idxs
        self._solo = [self._prepare_solo(blocks, i, cc, max_steps, slot)
                      for slot, (i, r) in enumerate(zip(solo_idxs,
                                                        solo_ranks))
                      if r == rank]
        fingerprint = self._fleet_fingerprint(blocks, cc, max_steps)
        start_step = 0
        if resume_path:
            start_step = self._load_state(ckpt_lib.resolve_trainstate(
                resume_path, "trainstate_fleet.npz"), fingerprint)

        step = start_step
        self.train_s = 0.0
        for ckpt in checkpoints or [max_steps]:
            if ckpt <= start_step:
                continue   # the stopped run wrote these artifacts
            n = ckpt - step
            if n > 0:
                # queue every bucket's steps, then wait once: fetching the
                # last losses ends the interval's host clock
                t0 = time.perf_counter()
                for st in self._states:
                    st.losses = self._run_segment(st, cc, n)
                for ss in self._solo:
                    self._run_solo_to(ss, ckpt, max_steps)
                self._gather_losses()
                self.train_s += time.perf_counter() - t0
                if progress_cb is not None:
                    progress_cb(ckpt, np.asarray(self.block_losses()))
            step = ckpt
            if checkpoint_cb is not None:
                checkpoint_cb(step, blocks, self._fleet_params(blocks))
            # state after the artifacts: a run stopped mid-checkpoint keeps
            # the previous state beside the previous artifacts; on several
            # ranks every rank takes part in the gather
            if state_path is not None or mesh.world() > 1:
                self._save_state(state_path, step, fingerprint)
        for blk, p in zip(blocks, self._fleet_params(blocks)):
            blk["params"] = p
        return blocks

    def _fleet_fingerprint(self, blocks: List[Dict], cc, max_steps: int
                           ) -> Dict:
        """Config axes a stored fleet state is only meaningful under;
        max_steps is one (unlike the single trainer's), as in the JAX
        package, whose solo blocks' checkpoint targets depend on it; so is
        each solo block's own step-level config, its kernel flag, each
        bucket's vector_len and each block's raw gather.  The ranks are
        not: the state holds whole buckets, as one rank writes it."""
        return {
            "kind": "fleet",
            "blocks": [str(b["name"]) for b in blocks],
            "models": [type(b["model"]).__name__ for b in blocks],
            "buckets": [[int(i) for i in st.block_idxs]
                        for st in self._states],
            "solo": [int(i) for i in self._solo_idxs],
            "optimizer": str(cc.optimizer_name_phi), "lr": float(cc.lr_phi),
            "sampler": str(cc.sampler.name), "seed": self.seed,
            "max_steps": int(max_steps), "half": bool(cc.half),
            "loss": f"{cc.loss.name}/{float(cc.loss.get('beta', 0.01))}",
            "coords_mode": str(cc.coords_mode),
            "fused": self.fused_paths(),
            "solo_cfg": [step_config(b["solo_cfg"]) if b.get("solo_cfg")
                         else None for b in blocks],
            "solo_fused": [bool(_solo_config(blocks[i], cc, max_steps,
                                             self.device)[1])
                           for i in self._solo_idxs],
            "vector_len": [int(st.vector_len) for st in self._states],
            "dequant": [b.get("dequant") is not None for b in blocks],
            "framework": "torch",
        }

    def _save_state(self, path: Optional[str], step: int,
                    fingerprint: Dict) -> None:
        """The whole fleet's training state, written atomically by rank 0
        (path None: gather only): b{i}p*, b{i}o*, b{i}key per bucket,
        s{i}p*, s{i}o*, s{i}key, s{i}done per solo block
        (train/checkpoint.py's leaf layout).  Every rank sends its rows
        and solo blocks (a collective)."""
        local = {
            "buckets": [(st.rows, _host_tree(st.params),
                         _host_tree([st.opt_state["mu"], st.opt_state["nu"]]),
                         st.opt_state["count"],
                         st.gen.get_state().numpy() if st.rows else None)
                        for st in self._states],
            "solo": {ss.slot: (_host_tree(ss.params),
                               _host_tree([ss.opt_state["mu"],
                                           ss.opt_state["nu"]]),
                               ss.opt_state["count"],
                               ss.gen.get_state().numpy(), ss.steps_done)
                     for ss in self._solo}}
        pieces = mesh.all_addressable(local)
        if path is None or not mesh.is_main():
            return
        arrs: Dict[str, np.ndarray] = {
            "step": np.asarray(int(step)),
            "fingerprint": ckpt_lib.fingerprint_bytes(fingerprint)}
        for bi in range(len(self._states)):
            held = [pc["buckets"][bi] for pc in pieces
                    if pc["buckets"][bi][0]]
            rows = [h[0] for h in held]
            params = _merge_rows([h[1] for h in held], rows)
            mu, nu = _merge_rows([h[2] for h in held], rows)
            ckpt_lib.pack_tree(arrs, f"b{bi}p", params)
            ckpt_lib.pack_opt(arrs, f"b{bi}o",
                              {"count": held[0][3], "mu": mu, "nu": nu})
            arrs[f"b{bi}key"] = held[0][4]
        solo = {k: v for pc in pieces for k, v in pc["solo"].items()}
        for si in range(len(self._solo_idxs)):
            params, (mu, nu), count, key, done = solo[si]
            ckpt_lib.pack_tree(arrs, f"s{si}p", params)
            ckpt_lib.pack_opt(arrs, f"s{si}o",
                              {"count": count, "mu": mu, "nu": nu})
            arrs[f"s{si}key"] = key
            arrs[f"s{si}done"] = np.asarray(int(done))
        ckpt_lib.atomic_savez(path, arrs)

    def _load_state(self, path: str, fingerprint: Dict) -> int:
        """Restore a _save_state file into the freshly prepared fleet, in
        place (this rank's rows and solo blocks); returns the stored
        step."""
        with np.load(path) as z:
            ckpt_lib.check_fingerprint(z, fingerprint, path)
            for bi, st in enumerate(self._states):
                ckpt_lib.unpack_tree(z, f"b{bi}p", st.params,
                                     f"b{bi} params", st.rows)
                ckpt_lib.unpack_opt(z, f"b{bi}o", st.opt_state,
                                    f"b{bi} opt_state", st.rows)
                ckpt_lib.unpack_generator(z, f"b{bi}key", st.gen)
            for ss in self._solo:
                prefix = f"s{ss.slot}"
                ckpt_lib.unpack_tree(z, f"{prefix}p", ss.params,
                                     f"{prefix} params")
                ckpt_lib.unpack_opt(z, f"{prefix}o", ss.opt_state,
                                    f"{prefix} opt_state")
                ckpt_lib.unpack_generator(z, f"{prefix}key", ss.gen)
                ss.steps_done = int(z[f"{prefix}done"])
            return int(z["step"])

    def _prepare_bucket(self, blocks: List[Dict], idxs: List[int], cc,
                        rows: Optional[List[int]] = None) -> _BucketState:
        """The state of bucket `idxs` for the rows (positions in idxs)
        this rank trains, all of them by default.  Widths, init, voxel
        padding, vector_len and the threshold flag are the whole
        bucket's."""
        dev = self.device
        sub = [blocks[i] for i in idxs]
        rows = list(range(len(idxs))) if rows is None else list(rows)
        spec, params, masks = build_stacked(
            [b["model"] for b in sub], self.seed,
            [b.get("init_layers") for b in sub], "cpu")
        params = tree_map(lambda t: t[rows].to(dev), params)
        masks = [m[rows].to(dev) for m in masks]

        # the clipped cube is bucket-static; when it covers every block
        # exactly, randomcube is the (cheaper, exact) full batch
        sampler_name = sub[0]["sampler_name"]
        cube_len: Tuple[int, ...] = ()
        if sampler_name == "randomcube":
            cube_len = tuple(min(int(c), s) for c, s in
                             zip(cc.sampler.cube_len,
                                 sub[0]["data_norm"].shape[:-1]))
            if all(tuple(b["data_norm"].shape[:-1]) == cube_len
                   for b in sub):
                sampler_name = "fullbatch"
        # runs of vector_len voxels, clamped to the bucket's shortest last
        # axis; the voxel axis padded to a multiple of it (the aligned
        # rows' Vmax % L == 0, JAX block_trainer.py:1001-1010)
        vec = min(int(cc.sampler.get("vector_len", 1) or 1),
                  min(int(b["data_norm"].shape[-2]) for b in sub)) \
            if sampler_name == "randompoint" else 1
        batch = BlockBatch.build(sub, pad_multiple=max(1, vec), rows=rows)
        # all-ones weights (the default) skip the weight stack entirely
        unit_weight = all(bool(np.all(b["weight"] == 1.0)) for b in sub)
        voxels = [int(np.prod(b["data_norm"].shape[:-1])) for b in sub]

        # 0.0 is the "override disabled" sentinel (loss.py `if
        # weight_thres:`); per block it becomes -inf so `pred <= thres`
        # never fires for disabled blocks in a bucket with enabled ones
        thres_host = np.asarray([float(b.get("weight_thres_norm", 0.0))
                                 for b in sub], np.float32)
        thres = torch.tensor(np.where(thres_host == 0.0, -np.inf,
                                      thres_host).astype(np.float32)[rows],
                             device=dev)
        opt = make_optimizer(cc.optimizer_name_phi, float(cc.lr_phi),
                             cc.lr_scheduler_phi)

        # every plain bucket, of any depth and width, takes the kernel
        # (JAX block_trainer.py:1053-1066)
        fused = bool(cc.get("fused_train", True)) and dev.type == "cuda" \
            and fleet_fused_supported(spec, cc.loss.name, sampler_name,
                                      bool(cc.half))

        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        to = lambda a: None if a is None else torch.from_numpy(a).to(dev)
        return _BucketState(
            block_idxs=list(idxs), rows=rows,
            models=[b["model"] for b in sub], spec=spec, params=params,
            opt_state=opt.init({"layers": params["layers"]}), masks=masks,
            batch=batch,
            data=device_raw(batch.data, dev),
            weight=None if unit_weight else to(batch.weight),
            valid=to(batch.valid), shapes=to(batch.shapes), opt=opt,
            gen=gen, thres=thres, use_thres=bool(np.any(thres_host != 0.0)),
            sampler_name=sampler_name, cube_len=cube_len, vector_len=vec,
            dq_scale=to(batch.dq_scale), dq_offset=to(batch.dq_offset),
            half=bool(cc.half), fused=fused,
            occupancy=sum(voxels) / (len(sub) * batch.vmax))

    def _prepare_solo(self, blocks: List[Dict], idx: int, cc,
                      fleet_max_steps: int, slot: int = 0) -> _SoloState:
        """The single-volume trainer's state for one block (JAX
        block_trainer.py:1101-1165): its own init (or warm start), and the
        sampler, optimizer, loss and max_steps of its own Compress node
        (`solo_cfg`, else the fleet's); on the card a plain chain trains
        on the one-chain train kernel, as NFGR trains it.  slot: its place
        among the fleet's solo blocks."""
        dev = self.device
        blk = blocks[idx]
        scc, fused, total = _solo_config(blk, cc, fleet_max_steps, dev)
        model = blk["model"]
        params = tree_map(lambda t: t.to(dev),
                          model.init(_block_generator(self.seed, idx)))
        warm = blk.get("init_layers")
        if warm is not None and isinstance(model, _ChainModel):
            params["layers"] = [{k: torch.tensor(np.asarray(v, np.float32),
                                                 device=dev)
                                 for k, v in l.items()} for l in warm]
        spatial = tuple(int(s) for s in blk["data_norm"].shape[:-1])
        c = blk["data_norm"].shape[-1]
        unit_weight = bool(np.all(blk["weight"] == 1.0))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if blk["sampler_name"] == "randomcube":
            clipped = tuple(min(int(cl), s) for cl, s in
                            zip(scc.sampler.cube_len, spatial))
            sampler = RandomCubeSampler(spatial, scc.coords_mode,
                                        int(scc.sampler.cube_count), clipped)
            data = to(blk["data_norm"])
            weight = None if unit_weight else to(blk["weight"])
        else:
            # the raw integer chunk where divide_runner recorded one
            dq = blk.get("dequant")
            raw = blk.get("data_raw") if dq is not None else None
            sampler = RandomPointSampler(
                spatial, scc.coords_mode, int(scc.sampler.sample_size),
                min(int(scc.sampler.get("vector_len", 1) or 1),
                    int(np.prod(spatial))),
                *(dq if raw is not None else (1.0, 0.0)),
                raw_uint16=raw is not None and raw.dtype == np.uint16)
            data = device_raw(raw.reshape(-1, c), dev) if raw is not None \
                else to(blk["data_norm"].reshape(-1, c))
            weight = None if unit_weight else \
                to(blk["weight"].reshape(-1, c))
        opt = make_optimizer(scc.optimizer_name_phi, float(scc.lr_phi),
                             scc.lr_scheduler_phi)
        gen = torch.Generator(device=sampler.generator_device(dev))
        gen.manual_seed((self.seed + 1) * 100003 + idx)
        return _SoloState(
            slot=slot, block_idx=idx, model=model, params=params,
            opt_state=opt.init(params), opt=opt, gen=gen, sampler=sampler,
            data=data, weight=weight,
            thres=float(blk.get("weight_thres_norm", 0.0)), cc=scc,
            total_steps=total, fused=fused)

    def _run_solo_to(self, ss: _SoloState, fleet_step: int,
                     fleet_max_steps: int) -> None:
        """Advance one solo block to its proportional step, round(
        fleet_step * its max_steps / the fleet's): a block with a max_steps
        of its own finishes at the fleet's last checkpoint (JAX
        block_trainer.py:1203-1213)."""
        target = round(fleet_step * ss.total_steps / max(1, fleet_max_steps))
        self._run_solo_segment(ss, target - ss.steps_done)

    def _run_solo_segment(self, ss: _SoloState, n_steps: int) -> None:
        """n_steps of the single-volume trainer's step (the fused kernel's
        or autograd's) for one solo block under its own config; the losses
        stay on the device."""
        from brief_pytorch_tpu_torch.train.fit import NFGR
        cc = ss.cc
        kw = dict(model=ss.model, sampler=ss.sampler, data=ss.data,
                  weight=ss.weight, loss_name=cc.loss.name,
                  beta=float(cc.loss.get("beta", 0.01)),
                  weight_thres=ss.thres)
        step = NFGR._fused_step if ss.fused else functools.partial(
            NFGR._autograd_step, half=bool(cc.half))
        losses = []
        for _ in range(max(0, n_steps)):
            loss, grads = step(ss.params, ss.gen, **kw)
            ss.opt.step(ss.params, grads, ss.opt_state)
            losses.append(loss.detach())
        if losses:
            ss.losses = torch.stack(losses)
            ss.steps_done += len(losses)

    def solo_blocks(self) -> List[int]:
        """Indices of the blocks that train on the solo path."""
        return list(self._solo_idxs)

    def _run_segment(self, st: _BucketState, cc, n_steps: int):
        return run_block_segment(
            st, n_steps, loss_name=cc.loss.name,
            beta=float(cc.loss.get("beta", 0.01)),
            sample_size=int(cc.sampler.sample_size),
            coords_mode=cc.coords_mode,
            cube_count=int(cc.sampler.cube_count))

    def _gather_losses(self) -> None:
        """The last step's losses of every bucket (B,) and solo block (1,)
        that has trained, from every rank (a collective)."""
        pieces = mesh.all_addressable({
            "buckets": [(st.rows, st.losses[-1].cpu().numpy())
                        for st in self._states],
            "solo": {ss.slot: ss.losses[-1:].cpu().numpy()
                     for ss in self._solo if ss.losses is not None}})
        out = []
        for bi in range(len(self._states)):
            held = [pc["buckets"][bi] for pc in pieces]
            out.append(_merge_rows([h[1] for h in held],
                                   [h[0] for h in held]))
        solo = {k: v for pc in pieces for k, v in pc["solo"].items()}
        self._solo_losses = solo
        self.last_losses = out + [solo[k] for k in sorted(solo)]

    def block_losses(self) -> List[float]:
        """The last step's loss of every block, in block order (NaN for a
        solo block that has not stepped yet)."""
        out = {i: float("nan") for i in self._solo_idxs}
        for st, losses in zip(self._states, self.last_losses):
            out.update(zip(st.block_idxs, (float(x) for x in losses)))
        for slot, lv in self._solo_losses.items():
            out[self._solo_idxs[slot]] = float(lv[0])
        return [out[i] for i in range(len(out))]

    def fused_paths(self) -> List[bool]:
        """Per-bucket fused-kernel flags (True: the fused train kernel runs
        that bucket; False: autograd)."""
        return [bool(st.fused) for st in self._states]

    def fleet_stats(self) -> List[Dict]:
        """Per-bucket occupancy: how much of the padded voxel grid is real
        data (fullbatch compute scales with the grid).  data_bytes: the
        stack this rank holds."""
        return [{
            "blocks": len(st.block_idxs), "vmax": st.batch.vmax,
            "sampler": st.sampler_name,
            "families": type(st.models[0]).__name__,
            "widths": [st.spec.dims[0][0]] + [o for _, o in st.spec.dims],
            "fused": bool(st.fused), "vector_len": int(st.vector_len),
            "data_dtype": str(st.batch.data.dtype),
            "data_bytes": int(st.data.numel() * st.data.element_size()),
            "voxel_occupancy": st.occupancy,
        } for st in self._states]

    def _fleet_params(self, blocks: List[Dict]) -> List[Dict]:
        """Per-block true-width params (CPU tensors), in block order, from
        every rank (a collective)."""
        local: Dict[int, Dict] = {}
        for st in self._states:
            local.update(zip(st.own_idxs, unstack_params(
                st.params["layers"], st.own_models,
                st.params.get("encoder"))))
        for ss in self._solo:
            local[ss.block_idx] = tree_map(
                lambda t: t.detach().cpu().clone(), ss.params)
        merged = {k: v for pc in mesh.all_addressable(local)
                  for k, v in pc.items()}
        return [merged[i] for i in range(len(blocks))]

    def decode(self, blocks: List[Dict], cc) -> List[np.ndarray]:
        """Decode every block (batched padded grid inference) and return
        per-block float32 arrays in their true shapes, in block order;
        each rank decodes its own blocks, and every rank gets all (a
        collective)."""
        results: Dict[int, np.ndarray] = {}
        for st in self._states:
            if not st.rows:
                continue
            slab = max(128, min(1 << 15, st.batch.vmax))
            slab = ((slab + 127) // 128) * 128
            out = decode_blocks(st.params["layers"], st.masks, st.shapes,
                                st.spec, slab=slab,
                                coords_mode=cc.coords_mode,
                                vmax=st.batch.vmax,
                                enc=st.params.get("encoder"),
                                half=bool(cc.half)).cpu().numpy()
            for i, bi in enumerate(st.own_idxs):
                shape = blocks[bi]["data_norm"].shape
                v = int(math.prod(shape[:-1]))
                results[bi] = out[i, :v].reshape(shape)
        for ss in self._solo:
            from brief_pytorch_tpu_torch.train.decode import \
                reconstruct_flattened
            results[ss.block_idx] = reconstruct_flattened(
                ss.model, ss.params, blocks[ss.block_idx]["data_norm"].shape,
                1 << 15, ss.cc.coords_mode, bool(ss.cc.half))
        merged = {k: v for pc in mesh.all_addressable(results)
                  for k, v in pc.items()}
        return [merged[i] for i in range(len(blocks))]
