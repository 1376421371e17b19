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
chain structure (MFNFourier, MFNGabor) train on the solo path: one block at
a time with the single-volume trainer's sampler and autograd step
(train/fit.py), in lockstep with the buckets between checkpoints.

The fleet's whole training state (every bucket's and solo block's
parameters, optimizer state and generator, the solo blocks' steps) is
written at every checkpoint, and `train(..., resume_path=...)` continues
from it, bitwise equal to an uninterrupted run with the same checkpoint
grid (JAX block_trainer.py:792-913).

One card: no mesh.  Not ported (each raises NotImplementedError, see
ROADMAP.md): solo blocks whose `exception` overrides step-level
parameters, `half`, integer stacks (raw_gather), vector_len > 1, and more
than one card.
"""
from __future__ import annotations

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
from brief_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from brief_pytorch_tpu_torch.train.optim import make_optimizer
from brief_pytorch_tpu_torch.train.samplers import (RandomCubeSampler,
                                                    RandomPointSampler,
                                                    cube_size_guard)

_NOT_PORTED = "is not ported yet (ROADMAP.md, 'Still to port')"


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
                  spec: StackedChainSpec, enc: Optional[Dict] = None
                  ) -> torch.Tensor:
    """Batched forward of B padded chains: coords (B, N, C) -> (B, N, Cout).
    enc: the stacked frozen encoder parameters ('ffn': bvals (B, embsize,
    c)), which get no gradient.

    Masking after each hidden entry's activation zeroes padded units,
    which keeps the active network exact (adding 0.0 terms to a float sum
    is exact) and kills every gradient path into padding.  The skip concat
    stays aligned because the encoder's width is topology-level (equal
    across the bucket) and valid hidden units are the leading columns of
    the padded block."""
    if spec.encoder == "ffn":
        enc = {"bvals": enc["bvals"].detach()}
    x = encode(coords, spec, enc)
    h = x
    li = 0
    n_ent = spec.n_entries

    def linear(h, layer):
        return torch.baddbmm(layer["b"][:, None, :], h, layer["w"])

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
    data: np.ndarray           # (B, Vmax, c) float32
    weight: np.ndarray         # (B, Vmax, c) float32
    valid: np.ndarray          # (B,) int64 true voxel counts
    shapes: np.ndarray         # (B, ndim) int64 spatial extents
    vmax: int
    ndim: int

    @staticmethod
    def build(blocks: List[Dict]) -> "BlockBatch":
        """blocks: dicts with 'data_norm' (*spatial, c) float32 and
        'weight' of the same shape.  Integer stacks (the JAX package's
        raw_gather) are not ported."""
        if any(b.get("dequant") is not None for b in blocks):
            raise NotImplementedError(f"integer stacks (raw_gather) "
                                      f"{_NOT_PORTED}")
        ndim = blocks[0]["data_norm"].ndim - 1
        c = blocks[0]["data_norm"].shape[-1]
        vmax = max(int(np.prod(b["data_norm"].shape[:-1])) for b in blocks)
        B = len(blocks)
        data = np.zeros((B, vmax, c), np.float32)
        weight = np.zeros((B, vmax, c), np.float32)
        valid = np.zeros((B,), np.int64)
        shapes = np.ones((B, ndim), np.int64)
        for i, b in enumerate(blocks):
            v = int(np.prod(b["data_norm"].shape[:-1]))
            data[i, :v] = b["data_norm"].reshape(v, c)
            weight[i, :v] = b["weight"].reshape(v, c)
            valid[i] = v
            shapes[i] = b["data_norm"].shape[:-1]
        return BlockBatch(data, weight, valid, shapes, vmax, ndim)


# --------------------------------------------------------------------------
# fleet draws (batched over the block axis)
# --------------------------------------------------------------------------
def point_axes(u: torch.Tensor, shapes: torch.Tensor) -> torch.Tensor:
    """randompoint: per-axis voxel indices min(floor(u * S), S - 1) of
    uniform u (B, S, ndim) in [0, 1) for blocks of shapes (B, ndim)."""
    s = shapes[:, None, :]
    return torch.minimum((u * s.to(u.dtype)).to(torch.int64), s - 1)


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
    """stack (B, Vmax, c)[b, idx[b]] -> (B, S, c)."""
    return torch.gather(stack, 1, idx[..., None].expand(
        -1, -1, stack.shape[-1]))


def draw_batch(sampler: str, gen: torch.Generator, data: torch.Tensor,
               weight: Optional[torch.Tensor], valid: torch.Tensor,
               shapes: torch.Tensor, coords_mode: str, *, sample_size: int,
               cube_count: int = 1, cube_len: Sequence[int] = ()):
    """One step's batch for every block of a bucket, in one batched call:
    (coords (B, S, ndim), values (B, S, c), weights (B, S, c),
    sample_valid (B, S, 1) or None)."""
    B, vmax, _ = data.shape
    ndim = shapes.shape[1]
    sample_valid = None
    if sampler == "fullbatch":
        idx = torch.arange(vmax, device=data.device).expand(B, vmax)
        axes = flat_to_axes24(idx, shapes[:, None, :])
        sample_valid = (idx < valid[:, None])[..., None].to(data.dtype)
        vals = data
        wts = weight
    else:
        if sampler == "randomcube":
            u = torch.rand((B, cube_count, ndim), generator=gen,
                           device=data.device)
            axes = cube_positions(cube_corners(u, shapes, cube_len),
                                  cube_len).reshape(B, -1, ndim)
        elif sampler == "randompoint":
            u = torch.rand((B, sample_size, ndim), generator=gen,
                           device=data.device)
            axes = point_axes(u, shapes)
        else:
            raise NotImplementedError(sampler)
        idx = (axes * row_major_strides(shapes)[:, None, :]).sum(-1)
        vals = _take(data, idx)
        wts = None if weight is None else _take(weight, idx)
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
    """Live training state of one stacked bucket."""
    block_idxs: List[int]          # indices into the fleet's block list
    models: List
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
    fused: bool = False
    losses: Optional[torch.Tensor] = None   # (steps, B) of the last segment


@dataclass
class _SoloState:
    """Training state of a block that cannot join a stacked bucket: a φ
    family without chain structure (the MFNs' multiplicative filters).  It
    trains alone with the single-volume trainer's sampler and autograd
    step — what one reference child process did (main.py:277-280)."""
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
    steps_done: int = 0
    losses: Optional[torch.Tensor] = None   # (steps,) of the last segment


def run_block_segment(st: _BucketState, n_steps: int, *, loss_name: str,
                      beta: float, sample_size: int, coords_mode: str,
                      cube_count: int = 1) -> torch.Tensor:
    """n_steps of simultaneous training for all B blocks of a bucket
    (JAX block_trainer.py:404-631 as a step loop).  Updates st.params and
    st.opt_state in place; returns the losses (n_steps, B) on the device
    without waiting for it."""
    acts = tuple((a, float(w0)) for _, a, w0 in st.spec.entries)
    unit_masks = list(st.masks[:-1]) + [None]   # the output is unmasked
    thres = st.thres if st.use_thres else None
    layers = st.params["layers"]
    enc = st.params.get("encoder")
    trained = {"layers": layers}      # the frozen encoder is not stepped
    leaves = tree_leaves(trained)
    losses = []
    for _ in range(n_steps):
        coords, vals, wts, sample_valid = draw_batch(
            st.sampler_name, st.gen, st.data, st.weight, st.valid, st.shapes,
            coords_mode, sample_size=sample_size, cube_count=cube_count,
            cube_len=st.cube_len)
        if st.fused:
            loss, grads = fused_train.fused_train_grads_fleet(
                layers, coords.transpose(1, 2).contiguous(),
                vals.transpose(1, 2).contiguous(),
                wts.transpose(1, 2).contiguous(), acts, loss_name=loss_name,
                beta=beta, unit_masks=unit_masks, thres=thres)
        else:
            for t in leaves:
                t.requires_grad_(True)
            try:
                pred = stacked_apply(layers, st.masks, coords, st.spec, enc)
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
            grads = {"layers": [{k: next(it) for k in l} for l in layers]}
            loss = loss.detach()
        st.opt.step(trained, grads, st.opt_state)
        losses.append(loss)
    return torch.stack(losses)


@torch.no_grad()
def decode_blocks(params_layers, masks, shapes: torch.Tensor,
                  spec: StackedChainSpec, *, slab: int, coords_mode: str,
                  vmax: int, enc: Optional[Dict] = None) -> torch.Tensor:
    """Batched padded grid decode: (B, Vmax, c) predictions, slab by slab
    of flat indices, coordinates from affine per-block formulas (JAX
    block_trainer.py:634-661)."""
    out = []
    for s in range(0, vmax, slab):
        idx = torch.arange(s, min(vmax, s + slab), device=shapes.device)
        axes = flat_to_axes24(idx[None, :], shapes[:, None, :])
        coords = axes_to_coords(axes, shapes[:, None, :], coords_mode)
        out.append(stacked_apply(params_layers, masks, coords, spec, enc))
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------------
# the fleet
# --------------------------------------------------------------------------
class BlockFleetTrainer:
    """Trains a fleet of per-block INRs as stacked buckets on one card.

    Buckets group blocks by (phi family, topology, effective sampler);
    widths inside a bucket are padded to the max.  Blocks that do not stack
    (the MFN families) train on the solo path, one after another.  Buckets
    and solo blocks advance in lockstep between checkpoints, so a
    checkpoint callback sees the whole fleet at one step, as the
    reference's children all checkpoint at the same step numbers
    (main.py:585-607).  Segments are queued without waiting for the card;
    the one sync per checkpoint interval is the fetch of the last losses.
    """

    def __init__(self, seed: int = 42, device: DeviceLike = None):
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._states: List[_BucketState] = []
        self._solo: List[_SoloState] = []
        self.train_s = 0.0           # host seconds in the training steps
        # the last step's losses: per bucket (B,), then per solo block (1,)
        self.last_losses: List[np.ndarray] = []

    def train(self, blocks: List[Dict], compress_cfg, max_steps: int,
              checkpoint_cb=None, checkpoints: Optional[List[int]] = None,
              state_path: Optional[str] = None,
              resume_path: Optional[str] = None) -> List[Dict]:
        """blocks: dicts with keys data_norm, weight, model (PhiModel),
        name, weight_thres_norm.  Returns blocks with 'params' attached.

        compress_cfg: the Compress config node (sampler, loss, lr, ...).
        checkpoint_cb(step, blocks, per_block_params) fires at every entry
        of `checkpoints` with the whole fleet.  state_path: write the
        fleet's training state (stacked params, optimizer states,
        generator states) there at every checkpoint, atomically.
        resume_path: a state file (or a run dir holding
        trainstate_fleet.npz) written so under the same config; training
        continues from its step, and checkpoints up to it are skipped."""
        cc = compress_cfg
        if bool(cc.half):
            raise NotImplementedError(f"Compress.half (bf16) {_NOT_PORTED}")
        if int(cc.sampler.get("vector_len", 1) or 1) > 1:
            raise NotImplementedError(f"sampler vector_len > 1 {_NOT_PORTED}")
        buckets: Dict[tuple, List[int]] = {}
        solo_idxs: List[int] = []
        for i, blk in enumerate(blocks):
            if blk.get("solo_cfg") is not None:
                raise NotImplementedError(
                    f"block {blk['name']}: an exception overriding step-level "
                    f"parameters needs the fleet's solo path, which "
                    f"{_NOT_PORTED}")
            m = blk["model"]
            # the reference's 80^3 cube guard, on each block's own size
            shape = blk["data_norm"].shape[:-1]
            clipped = tuple(min(int(c), s) for c, s in
                            zip(cc.sampler.cube_len, shape))
            eff = cube_size_guard(cc.sampler.name, int(np.prod(shape)),
                                  int(np.prod(clipped)))
            blk["sampler_name"] = eff
            if not isinstance(m, _ChainModel):
                solo_idxs.append(i)
                continue
            sig = (type(m).__name__, _stack_signature(m.spec), eff,
                   clipped if eff == "randomcube" else ())
            buckets.setdefault(sig, []).append(i)
        self._states = [self._prepare_bucket(blocks, idxs, cc)
                        for idxs in buckets.values()]
        self._solo = [self._prepare_solo(blocks, i, cc) for i in solo_idxs]
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
                    self._run_solo_to(ss, cc, ckpt)
                self.last_losses = [st.losses[-1].cpu().numpy()
                                    for st in self._states] + \
                    [ss.losses[-1:].cpu().numpy() for ss in self._solo
                     if ss.losses is not None]
                self.train_s += time.perf_counter() - t0
            step = ckpt
            if checkpoint_cb is not None:
                checkpoint_cb(step, blocks, self._fleet_params(blocks))
            # state after the artifacts: a run stopped mid-checkpoint keeps
            # the previous state beside the previous artifacts
            if state_path is not None:
                self._save_state(state_path, step, fingerprint)
        for blk, p in zip(blocks, self._fleet_params(blocks)):
            blk["params"] = p
        return blocks

    def _fleet_fingerprint(self, blocks: List[Dict], cc, max_steps: int
                           ) -> Dict:
        """Config axes a stored fleet state is only meaningful under;
        max_steps is one (unlike the single trainer's), as in the JAX
        package, whose solo blocks' checkpoint targets depend on it."""
        return {
            "kind": "fleet",
            "blocks": [str(b["name"]) for b in blocks],
            "models": [type(b["model"]).__name__ for b in blocks],
            "buckets": [[int(i) for i in st.block_idxs]
                        for st in self._states],
            "solo": [int(ss.block_idx) for ss in self._solo],
            "optimizer": str(cc.optimizer_name_phi), "lr": float(cc.lr_phi),
            "sampler": str(cc.sampler.name), "seed": self.seed,
            "max_steps": int(max_steps), "half": bool(cc.half),
            "loss": f"{cc.loss.name}/{float(cc.loss.get('beta', 0.01))}",
            "coords_mode": str(cc.coords_mode),
            "fused": self.fused_paths(),
            "framework": "torch",
        }

    def _save_state(self, path: str, step: int, fingerprint: Dict) -> None:
        """The whole fleet's training state, written atomically: b{i}p*,
        b{i}o*, b{i}key per bucket, s{i}p*, s{i}o*, s{i}key, s{i}done per
        solo block (train/checkpoint.py's leaf layout)."""
        arrs: Dict[str, np.ndarray] = {
            "step": np.asarray(int(step)),
            "fingerprint": ckpt_lib.fingerprint_bytes(fingerprint)}
        for prefix, state in self._named_states():
            ckpt_lib.pack_tree(arrs, f"{prefix}p", state.params)
            ckpt_lib.pack_opt(arrs, f"{prefix}o", state.opt_state)
            arrs[f"{prefix}key"] = state.gen.get_state().numpy()
        for si, ss in enumerate(self._solo):
            arrs[f"s{si}done"] = np.asarray(int(ss.steps_done))
        ckpt_lib.atomic_savez(path, arrs)

    def _load_state(self, path: str, fingerprint: Dict) -> int:
        """Restore a _save_state file into the freshly prepared fleet, in
        place; returns the stored step."""
        with np.load(path) as z:
            ckpt_lib.check_fingerprint(z, fingerprint, path)
            for prefix, state in self._named_states():
                ckpt_lib.unpack_tree(z, f"{prefix}p", state.params,
                                     f"{prefix} params")
                ckpt_lib.unpack_opt(z, f"{prefix}o", state.opt_state,
                                    f"{prefix} opt_state")
                ckpt_lib.unpack_generator(z, f"{prefix}key", state.gen)
            for si, ss in enumerate(self._solo):
                ss.steps_done = int(z[f"s{si}done"])
            return int(z["step"])

    def _named_states(self):
        """(prefix, state) of every bucket (b{i}) and solo block (s{i})."""
        return [(f"b{bi}", st) for bi, st in enumerate(self._states)] + \
            [(f"s{si}", ss) for si, ss in enumerate(self._solo)]

    def _prepare_bucket(self, blocks: List[Dict], idxs: List[int], cc
                        ) -> _BucketState:
        dev = self.device
        sub = [blocks[i] for i in idxs]
        models = [b["model"] for b in sub]
        spec, params, masks = build_stacked(
            models, self.seed, [b.get("init_layers") for b in sub], dev)

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
        batch = BlockBatch.build(sub)
        # all-ones weights (the default) skip the weight stack entirely
        unit_weight = all(bool(np.all(b["weight"] == 1.0)) for b in sub)

        # 0.0 is the "override disabled" sentinel (loss.py `if
        # weight_thres:`); per block it becomes -inf so `pred <= thres`
        # never fires for disabled blocks in a bucket with enabled ones
        thres_host = np.asarray([float(b.get("weight_thres_norm", 0.0))
                                 for b in sub], np.float32)
        thres = torch.tensor(np.where(thres_host == 0.0, -np.inf,
                                      thres_host).astype(np.float32),
                             device=dev)
        opt = make_optimizer(cc.optimizer_name_phi, float(cc.lr_phi),
                             cc.lr_scheduler_phi)

        fused = bool(cc.get("fused_train", True)) and dev.type == "cuda" \
            and fleet_fused_supported(spec, cc.loss.name, sampler_name,
                                      bool(cc.half))
        if fused:   # a bucket too wide for the kernel raises here
            fused_train.kernel_plan([spec.dims[0][0]] +
                                    [o for _, o in spec.dims])

        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        to = lambda a: torch.from_numpy(a).to(dev)
        return _BucketState(
            block_idxs=list(idxs), models=models, spec=spec, params=params,
            opt_state=opt.init({"layers": params["layers"]}), masks=masks,
            batch=batch,
            data=to(batch.data),
            weight=None if unit_weight else to(batch.weight),
            valid=to(batch.valid), shapes=to(batch.shapes), opt=opt,
            gen=gen, thres=thres, use_thres=bool(np.any(thres_host != 0.0)),
            sampler_name=sampler_name, cube_len=cube_len, fused=fused)

    def _prepare_solo(self, blocks: List[Dict], idx: int, cc) -> _SoloState:
        """The single-volume trainer's state for one block (JAX
        block_trainer.py:1101-1165): its own init, sampler and optimizer."""
        dev = self.device
        blk = blocks[idx]
        model = blk["model"]
        params = tree_map(lambda t: t.to(dev),
                          model.init(_block_generator(self.seed, idx)))
        spatial = tuple(int(s) for s in blk["data_norm"].shape[:-1])
        c = blk["data_norm"].shape[-1]
        unit_weight = bool(np.all(blk["weight"] == 1.0))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if blk["sampler_name"] == "randomcube":
            clipped = tuple(min(int(cl), s) for cl, s in
                            zip(cc.sampler.cube_len, spatial))
            sampler = RandomCubeSampler(spatial, cc.coords_mode,
                                        int(cc.sampler.cube_count), clipped)
            data = to(blk["data_norm"])
            weight = None if unit_weight else to(blk["weight"])
        else:
            sampler = RandomPointSampler(spatial, cc.coords_mode,
                                         int(cc.sampler.sample_size))
            data = to(blk["data_norm"].reshape(-1, c))
            weight = None if unit_weight else \
                to(blk["weight"].reshape(-1, c))
        opt = make_optimizer(cc.optimizer_name_phi, float(cc.lr_phi),
                             cc.lr_scheduler_phi)
        gen = torch.Generator(device=sampler.generator_device(dev))
        gen.manual_seed((self.seed + 1) * 100003 + idx)
        return _SoloState(
            block_idx=idx, model=model, params=params,
            opt_state=opt.init(params), opt=opt, gen=gen, sampler=sampler,
            data=data, weight=weight,
            thres=float(blk.get("weight_thres_norm", 0.0)))

    def _run_solo_to(self, ss: _SoloState, cc, fleet_step: int) -> None:
        """Advance one solo block to the fleet's step.  (A block with a
        max_steps of its own would get a proportional target, JAX
        block_trainer.py:1205-1213; such blocks raise in `train`.)"""
        self._run_solo_segment(ss, cc, fleet_step - ss.steps_done)

    def _run_solo_segment(self, ss: _SoloState, cc, n_steps: int) -> None:
        """n_steps of the single-volume trainer's autograd step for one
        solo block; the losses stay on the device."""
        from brief_pytorch_tpu_torch.train.fit import NFGR
        losses = []
        for _ in range(max(0, n_steps)):
            loss, grads = NFGR._autograd_step(
                ss.params, ss.gen, model=ss.model, sampler=ss.sampler,
                data=ss.data, weight=ss.weight, loss_name=cc.loss.name,
                beta=float(cc.loss.get("beta", 0.01)),
                weight_thres=ss.thres)
            ss.opt.step(ss.params, grads, ss.opt_state)
            losses.append(loss.detach())
        if losses:
            ss.losses = torch.stack(losses)
            ss.steps_done += len(losses)

    def solo_blocks(self) -> List[int]:
        """Indices of the blocks that train on the solo path."""
        return [ss.block_idx for ss in self._solo]

    def _run_segment(self, st: _BucketState, cc, n_steps: int):
        return run_block_segment(
            st, n_steps, loss_name=cc.loss.name,
            beta=float(cc.loss.get("beta", 0.01)),
            sample_size=int(cc.sampler.sample_size),
            coords_mode=cc.coords_mode,
            cube_count=int(cc.sampler.cube_count))

    def fused_paths(self) -> List[bool]:
        """Per-bucket fused-kernel flags (True: the fused train kernel runs
        that bucket; False: autograd)."""
        return [bool(st.fused) for st in self._states]

    def fleet_stats(self) -> List[Dict]:
        """Per-bucket occupancy: how much of the padded voxel grid is real
        data (fullbatch compute scales with the grid)."""
        out = []
        for st in self._states:
            B = len(st.models)
            out.append({
                "blocks": B, "vmax": st.batch.vmax,
                "sampler": st.sampler_name,
                "families": type(st.models[0]).__name__,
                "widths": [st.spec.dims[0][0]] + [o for _, o in
                                                  st.spec.dims],
                "fused": bool(st.fused),
                "voxel_occupancy": int(st.batch.valid.sum())
                / (B * st.batch.vmax),
            })
        return out

    def _fleet_params(self, blocks: List[Dict]) -> List[Dict]:
        """Per-block true-width params (CPU tensors), in block order."""
        out: List[Optional[Dict]] = [None] * len(blocks)
        for st in self._states:
            for bi, p in zip(st.block_idxs,
                             unstack_params(st.params["layers"], st.models,
                                            st.params.get("encoder"))):
                out[bi] = p
        for ss in self._solo:
            out[ss.block_idx] = tree_map(lambda t: t.detach().cpu().clone(),
                                         ss.params)
        return out

    def decode(self, blocks: List[Dict], cc) -> List[np.ndarray]:
        """Decode every block (batched padded grid inference) and return
        per-block float32 arrays in their true shapes, in block order."""
        results: List[Optional[np.ndarray]] = [None] * len(blocks)
        for st in self._states:
            slab = max(128, min(1 << 15, st.batch.vmax))
            slab = ((slab + 127) // 128) * 128
            out = decode_blocks(st.params["layers"], st.masks, st.shapes,
                                st.spec, slab=slab,
                                coords_mode=cc.coords_mode,
                                vmax=st.batch.vmax,
                                enc=st.params.get("encoder")).cpu().numpy()
            for i, bi in enumerate(st.block_idxs):
                shape = blocks[bi]["data_norm"].shape
                v = int(math.prod(shape[:-1]))
                results[bi] = out[i, :v].reshape(shape)
        for ss in self._solo:
            from brief_pytorch_tpu_torch.train.decode import \
                reconstruct_flattened
            results[ss.block_idx] = reconstruct_flattened(
                ss.model, ss.params, blocks[ss.block_idx]["data_norm"].shape,
                1 << 15, cc.coords_mode)
        return results
