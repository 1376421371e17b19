"""Fused train-step gradients for plain activation chains, for one chain
or for a fleet of padded chains: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_train.py
(`_make_train_kernel` / `_fused_grads_padded`, entry `fused_train_grads`,
lines 70-357), in its single form (train/fit.py) and in the fleet form
that `jax.vmap` makes of it for the block fleet
(parallel/block_trainer.py:594-617): per-hidden-layer unit masks, a
per-block threshold and a block-index grid dimension.  One kernel runs,
per coordinate tile, the chain's forward (storing each activation and its
derivative), the weighted datal2 / datasmoothl1 loss with the weight_thres
override, and a backward with no transcendentals; a second pass adds the
blocks' partial sums in a fixed order.  It returns (loss, grads) already
divided by N * Cout and replaces autograd.

Bound on an H100: operations.  At the SingleTask run's shapes (SIREN
5 x 22, N = 262,144) the call moves ~5 MB but does ~3 GFLOP of float32
work (~45 us at 67 TFLOP/s).  The narrow layout runs its products on the
tensor cores in 3xTF32 (`tf32_split`): 2.388 GFLOP of products, 14.5 us
at 495 TFLOP/s TF32 times 3, and 0.577 GFLOP of sines, 8.6 us at 67
TFLOP/s (chip_smoke.py's tc_bound_ms, 0.0145 ms).  Neither paces it:
instruction throughput does (the sine epilogues, the TF32 splits,
fragment loads and stores) at the 16 warps per SM that its registers and
shared memory allow (PERF.md).

Three layouts; `choose_plan` takes the first that fits, and one always
does: any plain chain, of any depth and width, trains on the kernel.  Each
layout's per-layer values live in a small table in device memory
(`narrow_table`, `tiled_table`, `wide_table`; ops/chain.py layer_table),
made once per chain, so no layout bounds the depth:
  * narrow (`plan`, `narrow_plan`; 5 x 22, brain64's 3-7x4-1, the narrow
    φ families; 5 layers up to 33 features, 7 up to 24): W and W^T split
    into TF32 big and small parts in mma B-fragment order
    (`pack_fragments`), read in place from the layers' tensors, and one
    activation store per group of warps in shared memory; each warp
    carries 16 coordinates through the forward and the input gradients
    on mma.sync (no barrier between layers), and dW runs on the tensor
    cores over the group's coordinates, in jobs (`dw_jobs`) whose
    accumulators the warps keep in registers for the whole call.  Chains
    the old one-thread-per-coordinate layout took beyond that reach (5 x
    34-64, 7 x 25-48, ...) take the tiled layout, measured faster there;
  * tiled (`tiled_plan`; the HiP-CT bucket 3-64x6-1, 3-66x6-1, 5 x 95):
    W once, beside a 32-coordinate tile; 256 threads work on register
    micro-tiles of the three products and keep their share of dW
    (`dw_map`) in registers for the whole call, written once;
  * wide (`wide_plan`; the SingleTask default on the 64x512x512 demo
    volumes, 3-191x4-1 and 3-242x4-1, and fleet buckets past the tiled
    layout such as 3-128x6-1): W streamed through shared memory in slabs
    (ops/wide.py, csrc/wide.cuh), h_l and d_l of every coordinate in a
    device-memory scratch, dW a split-K product over it (`dw_split`).
    Its rows form holds two layers' rows of a tile in shared memory, up
    to 3,327 features at 8 coordinates a tile; past that its streamed
    form (`stream`; 3-4096-1, 3-20971-1) reads each layer's input and
    each g_l slab by slab from the scratch.  Its limit is device memory
    for the scratch, B * rows_total * round64(N) floats, which the
    wrapper reports as torch.cuda.OutOfMemoryError naming the bytes.
csrc/fused_train.cu says what bounds each.

`fused_train_grads_fleet` launches the kernel for CUDA tensors and calls
the plain version, `fused_train_grads_reference`, for CPU tensors; there
is no fallback from one to the other.  `fused_train_grads` is its one-chain
form (a fleet of one, which the C side runs without the fleet's parts).
Scope: acts sine, relu, sigmoid, none; losses datal2, datasmoothl1;
float32.  `half` never reaches the kernel: the trainers take autograd
for it, as the JAX gates do (train/fit.py:332, block_trainer.py:395).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from brief_pytorch_tpu_torch.ops import wide
from brief_pytorch_tpu_torch.ops.chain import (ACTS, LayerSpec,
                                               chain_layer_specs, f32_word,
                                               i64_words, layer_table,
                                               pad_row)
from brief_pytorch_tpu_torch.ops.fast_math import fast_sincos

LOSSES = ("datal2", "datasmoothl1")
SMEM_LIMIT = 232448          # bytes of shared memory one block may use (H100)
SM_SMEM = 233472             # bytes of shared memory of one SM (H100)
# (groups, warps per group) of a narrow-layout block, at most 16 warps
NARROW_GROUPS = ((1, 16), (2, 8), (4, 4), (1, 8), (2, 4), (4, 2), (1, 4),
                 (2, 2), (1, 2), (1, 1))
STAGE_CHANNELS = 16          # c_in + 2 c_out staged per tile (kMaxStage)
NARROW_JOBS = (1, 2, 4)      # dW jobs per warp: the narrow kernel's instances
MAX_JOBS = 4                 # kMaxJobs: job codes per warp in the table
JOB_TILES = 3                # kJobTiles: dW tiles of one job
NARROW_SM_WARPS = 16         # 32 * kNarrowMaxWarps threads, 128 registers each
SMALL_WARPS = 8              # kSmallWarps: warps per block of a small chain
NARROW_MIN_WARPS = 8         # fewer resident per SM: the tiled layout
FRAG = 128                   # floats of one packed B fragment (32 lanes x 4)
TILED_THREADS = 256          # kTiledThreads of csrc/fused_train.cu
TILED_TILE = 32              # kTile: coordinates per tile of the tiled layout
TILED_SLOTS = (4, 6, 8)      # dW tiles per thread: the kernel's instances
DW_CHUNK = 32                # kDwChunk: coordinates per dW operand chunk
DW_BLOCKS = 1056             # dW blocks aimed at per call: 8 per H100 SM
# int32 words of a layer's table row: sizeof NarrowLayer, TiledLayer
# (csrc/fused_train.cu) and wide::Layer (csrc/wide.cuh) / 4
NARROW_ROW_WORDS = 24
TILED_ROW_WORDS = 12
WIDE_ROW_WORDS = 16

launches = 0                 # kernel launches, for proof that a run used it

_SIGNATURES = {
    "brief_fused_train_occupancy": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    "brief_fused_train": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "brief_fused_train_tiled_occupancy": [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train_tiled": [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "brief_fused_train_wide_occupancy": [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train_wide": [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _tiles8(x: int) -> int:
    return -(-x // 8)


def plan(widths: Sequence[int], warps: int, groups: int = 1) -> Dict:
    """Layout of the narrow layout (csrc/fused_train.cu fused_train_kernel)
    for a chain of `widths` = (c_in, f_1, ..., c_out) and blocks of
    `groups` groups of `warps` warps (16 coordinates each; a group walks
    tiles of `block` = 16 * warps coordinates alone); offsets in floats.

    Shared memory: every layer's B fragments (16 bytes a lane, big and
    small of two entries; FRAG floats each): the forward's kb x nt over
    [W; b] ((fin + 1) x fout) and, from layer 1, the input gradient's
    kbb x ntb over W^T; then one activation store per group (`rows` rows
    of `stride` = block + 4 floats): the coordinates and a ones row
    (x_row[0]), per layer h with a ones row (h_row; not for the last
    layer) and d / g (g_row), the tile's values and weights (yw_row, 2
    c_out rows); x_row[l] is layer l's input; then the unit masks (one
    float per hidden unit, mask_sm) and one float per warp for the loss.
    `small`: every layer one n-tile wide (the kernel's kSmall instance).
    dW: layer l's (fin + 1) x fout gradient in 16 x 8 mma tiles
    (n_tiles in all), M over fout when that gives the fewest jobs, then
    tiles (dw_gmajor);
    `dw_jobs` cuts each row of M tiles into jobs of up to JOB_TILES that
    share their A operand, `job_table` deals them to the warps of a group
    and `jobs` is the smallest of NARROW_JOBS that holds every warp's (0:
    none does)."""
    n_layers = len(widths) - 1
    off, n_params = 0, 0
    p_off, wf_off, kb, nt = [], [], [], []
    for l in range(n_layers):
        fin, fout = widths[l], widths[l + 1]
        p_off.append(n_params)
        n_params += (fin + 1) * fout
        wf_off.append(off)
        kb.append(_tiles8(fin + 1))
        nt.append(_tiles8(fout + (l < n_layers - 1)))
        off += kb[-1] * nt[-1] * FRAG
    wb_off, kbb, ntb = [-1], [0], [0]
    for l in range(1, n_layers):
        fin, fout = widths[l], widths[l + 1]
        wb_off.append(off)
        kbb.append(_tiles8(fout))
        ntb.append(_tiles8(fin))
        off += kbb[-1] * ntb[-1] * FRAG
    act_off = off
    x_row, h_row, g_row = [0], [], []
    row = widths[0] + 1
    for l in range(n_layers):
        fout = widths[l + 1]
        if l < n_layers - 1:
            h_row.append(row)
            x_row.append(row)
            row += fout + 1
        else:
            h_row.append(-1)
        g_row.append(row)
        row += fout
    yw_row = row
    row += 2 * widths[-1]
    small = max(kb + nt + kbb[1:] + ntb[1:]) == 1
    job_tiles = 1 if small else JOB_TILES
    gmajor = [int(_job_count(f, i + 1, job_tiles)
                  <= _job_count(i + 1, f, job_tiles))
              for i, f in zip(widths[:-1], widths[1:])]
    jobs = dw_jobs(widths, gmajor, job_tiles)
    table, per_warp = job_table(jobs, warps)
    block = 16 * warps
    stride = block + 4
    mask_sm = act_off + groups * row * stride
    red_off = mask_sm + _round4(sum(widths[1:-1]))
    n_jobs = next((j for j in NARROW_JOBS if per_warp <= j), 0)
    if widths[0] + 2 * widths[-1] > STAGE_CHANNELS:
        n_jobs = 0   # the staged inputs exceed the kernel's registers
    return {"layout": "narrow", "n_params": n_params, "p_off": p_off,
            "wf_off": wf_off, "kb": kb, "nt": nt, "wb_off": wb_off,
            "kbb": kbb, "ntb": ntb, "act_off": act_off, "rows": row,
            "x_row": x_row, "h_row": h_row, "g_row": g_row,
            "yw_row": yw_row, "dw_gmajor": gmajor, "dw_jobs": jobs,
            "job_table": table, "n_tiles": sum(j[3] for j in jobs),
            "jobs": n_jobs, "small": small, "warps": warps,
            "groups": groups, "block": block,
            "threads": 32 * warps * groups, "stride": stride,
            "mask_sm": mask_sm, "red_off": red_off,
            "smem_bytes": 4 * (red_off + 32)}


def _narrow_weight_floats(widths: Sequence[int]) -> int:
    """Floats of the narrow layout's B fragments: the forward's and, from
    layer 1, the input gradient's."""
    fwd = sum(_tiles8(i + 1) * _tiles8(o + (l < len(widths) - 2))
              for l, (i, o) in enumerate(zip(widths[:-1], widths[1:])))
    bwd = sum(_tiles8(o) * _tiles8(i)
              for i, o in zip(widths[1:-1], widths[2:]))
    return FRAG * (fwd + bwd)


def _job_count(m: int, n: int, job_tiles: int) -> Tuple[int, int]:
    """(dW jobs, tiles) of an m x n gradient with M over m."""
    return -(-m // 16) * -(-_tiles8(n) // job_tiles), -(-m // 16) * _tiles8(n)


def dw_jobs(widths: Sequence[int], gmajor: Sequence[int],
            job_tiles: int = JOB_TILES) -> List[Tuple[int, int, int, int]]:
    """The narrow layout's dW jobs (layer, m-tile, first n-tile, n-tiles):
    every row of 16 x 8 tiles of a layer's (fin + 1) x fout gradient (M
    over fout where gmajor) cut into runs of up to `job_tiles` tiles that
    share the row's A operand (JOB_TILES; 1 for a small chain)."""
    jobs = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        m, nn = (fout, fin + 1) if gmajor[l] else (fin + 1, fout)
        for mt in range(-(-m // 16)):
            for n0 in range(0, _tiles8(nn), job_tiles):
                jobs.append((l, mt, n0, min(job_tiles, _tiles8(nn) - n0)))
    return jobs


def job_table(jobs, warps: int) -> Tuple[List[int], int]:
    """(codes, most jobs of one warp): the jobs dealt round-robin to a
    group's warps (every job costs the same: the kernel runs all
    JOB_TILES tiles of one, B zero past its own); MAX_JOBS codes per warp,
    layer << 24 | m-tile << 16 | first n-tile << 8 | n-tiles, -1 past."""
    codes = [-1] * (MAX_JOBS * NARROW_SM_WARPS)
    for j, (l, mt, n0, cnt) in enumerate(jobs):
        w, s = j % warps, j // warps
        if s < MAX_JOBS:
            codes[MAX_JOBS * w + s] = l << 24 | mt << 16 | n0 << 8 | cnt
    return codes, -(-len(jobs) // warps)


def resident_warps(p: Dict) -> int:
    """Warps of the narrow layout resident per SM at plan p: blocks by
    shared memory (1 KB reserved per block), at most NARROW_SM_WARPS (the
    kernel's launch bound gives it 128 registers a thread; for a small
    chain, three blocks of at most SMALL_WARPS warps, 80 registers)."""
    if not p["jobs"] or p["smem_bytes"] > SMEM_LIMIT:
        return 0
    block_warps = p["warps"] * p["groups"]
    if p["small"] and block_warps > SMALL_WARPS:
        return 0
    cap = 3 * SMALL_WARPS if p["small"] else NARROW_SM_WARPS
    return min(cap // block_warps * block_warps,
               block_warps * (SM_SMEM // (p["smem_bytes"] + 1024)))


def narrow_plan(widths: Sequence[int]) -> Optional[Dict]:
    """The narrow plan with the most resident warps per SM, then the fewest
    dW jobs per warp (the dW phase waits for the busiest warp), then the
    most groups per block (their barriers interleave), or None where none
    of NARROW_GROUPS fits (at once where the weights alone overflow a
    block, before any dW job is dealt)."""
    if 4 * _narrow_weight_floats(widths) > SMEM_LIMIT:
        return None
    best, best_key = None, (0, 0, 0)
    for groups, warps in NARROW_GROUPS:
        p = plan(widths, warps, groups)
        key = (resident_warps(p), -p["jobs"], groups)
        if key[0] and key > best_key:
            best, best_key = p, key
    return best


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def dw_tiles(widths: Sequence[int]) -> List[Tuple[int, int, int]]:
    """The tiled layout's dW tiles in order: (layer, ig, og) for the 4 x 4
    entries (4 ig + a, 4 og + b) of layer l's gradient seen as a
    (fin + 1, fout) matrix, the bias as row fin (entries past it or past
    fout are padding, computed and never written)."""
    return [(l, ig, og) for l in range(len(widths) - 1)
            for ig in range(_round4(widths[l] + 1) // 4)
            for og in range(_round4(widths[l + 1]) // 4)]


def dw_map(widths: Sequence[int], slots: int,
           threads: int = TILED_THREADS) -> List[List[int]]:
    """(slots, threads): the dW tile that thread t sums in registers in its
    k-th slot, coded layer << 16 | ig << 8 | og, or -1 (none).  Tile j of
    dw_tiles goes to thread j % threads, slot j // threads: 8 consecutive
    threads take 8 consecutive column quads of one row quad, whose rows
    the activation layout puts in 8 distinct bank quads."""
    tiles = dw_tiles(widths)
    if len(tiles) > slots * threads:
        raise ValueError(f"{len(tiles)} dW tiles exceed {slots} slots of "
                         f"{threads} threads")
    codes = [l << 16 | ig << 8 | og for l, ig, og in tiles]
    codes += [-1] * (slots * threads - len(codes))
    return [codes[k * threads:(k + 1) * threads] for k in range(slots)]


def tiled_plan(widths: Sequence[int]) -> Dict:
    """Shared-memory layout (in floats) of the tiled layout: the weights of
    every layer once, as (round4(fin + 1), round4(fout)) with the bias as
    row fin; a loss reduction buffer of one float per thread; then
    activation rows of TILED_TILE floats (one 128-byte line each): the
    coordinates with a ones row after them, and for every layer h_l (with
    a ones row: the next layer's bias input) and d_l / g_l, each block
    padded to a multiple of 4 rows.  `slots`: dW tiles per thread, the
    smallest of TILED_SLOTS that holds dw_tiles (0: none does)."""
    n_layers = len(widths) - 1
    off, n_params = 0, 0
    p_off, w_off, h_row, g_row = [], [], [], []
    for l in range(n_layers):
        fin, fout = widths[l], widths[l + 1]
        p_off.append(n_params)
        n_params += fin * fout + fout
        w_off.append(off)
        off += _round4(fin + 1) * _round4(fout)
    red_off = off
    act_off = (off + TILED_THREADS + 31) // 32 * 32   # 128-byte rows
    row = _round4(widths[0] + 1)
    for l in range(n_layers):
        h_row.append(row)
        row += _round4(widths[l + 1] + 1)
        g_row.append(row)
        row += _round4(widths[l + 1])
    n_tiles = sum(_round4(i + 1) // 4 * (_round4(o) // 4)
                  for i, o in zip(widths[:-1], widths[1:]))
    slots = next((s for s in TILED_SLOTS if n_tiles <= s * TILED_THREADS), 0)
    return {"layout": "tiled", "n_params": n_params, "p_off": p_off,
            "w_off": w_off, "x_row": [0] + h_row[:-1], "h_row": h_row,
            "g_row": g_row, "red_off": red_off, "act_off": act_off,
            "block": TILED_TILE, "threads": TILED_THREADS, "slots": slots,
            "smem_bytes": 4 * (act_off + row * TILED_TILE)}


def wide_plan(widths: Sequence[int], tile: int, stream: bool = False
              ) -> Dict:
    """Layout of the wide layout for a chain of `widths` and `tile`
    coordinates per tile (4 * tile threads).

    Shared memory: the rows form, two buffers of rows_max rows of `tile`
    floats and two weight slabs; the streamed form (`stream`, rows_max 0),
    two weight slabs, two slabs of KS operand rows and the last layer's
    c_out rows; then a loss buffer of one float per thread.  Scratch rows
    (each np = round64(N) floats; B * rows_total of them per call): the
    coordinates (x_row[0] = 0), then per layer h_l (h_row; none for the
    last layer) and d_l / g_l (g_row); x_row[l] is the layer's input.
    dW tiles: layer l's (fin + 1) x fout gradient in 64 x 64 tiles
    (i-block, o-block), numbered from tile0[l], o-blocks fastest."""
    n_layers = len(widths) - 1
    meta = wide.layer_meta(widths)
    rows = 0 if stream else wide.rows_max(widths)
    x_row, h_row, g_row, tile0 = [0], [], [], [0]
    row = widths[0]
    for l in range(n_layers):
        fout = widths[l + 1]
        if l < n_layers - 1:
            h_row.append(row)
            x_row.append(row)
            row += fout
        else:
            h_row.append(-1)
        g_row.append(row)
        row += fout
        tile0.append(tile0[-1] + -(-(widths[l] + 1) // wide.OB)
                     * -(-fout // wide.OB))
    threads = 4 * tile
    operand = 2 * wide.KS * tile + widths[-1] * tile if stream else 0
    pack = max(b - a for a, b in zip(meta["wp_off"][:-1], meta["wp_off"][1:]))
    return {"layout": "wide", "block": tile, "threads": threads,
            "stream": stream, "rows_max": rows, "rows_total": row,
            "x_row": x_row, "h_row": h_row, "g_row": g_row,
            "tile0": tile0[:-1], "n_dw_tiles": tile0[-1],
            "wp_total": meta["wp_off"][-1], "pack_blocks": -(-pack // 256),
            **meta, "smem_bytes": 4 * (2 * rows * tile + 2 * wide.SLAB +
                                       operand + threads)}


def dw_split(n: int, n_fleet: int, n_dw_tiles: int) -> Tuple[int, int, int]:
    """(np, splits, chunk) of the wide layout's dW product at N = n:
    coordinates [0, np) cut into `splits` runs of `chunk` (a multiple of
    DW_CHUNK; the last run ends at np), so that the grid holds about
    DW_BLOCKS blocks."""
    np_ = wide.round_up(n, wide.OB)
    want = -(-DW_BLOCKS // (n_dw_tiles * n_fleet))
    splits = max(1, min(want, np_ // (4 * DW_CHUNK)))
    chunk = wide.round_up(-(-np_ // splits), DW_CHUNK)
    return np_, -(-np_ // chunk), chunk


def choose_plan(widths: Sequence[int]) -> Dict:
    """The layout for a chain of any depth and width: the narrow layout
    (W, W^T and the activation store of a block's coordinates in shared
    memory, products on the tensor cores) when it keeps at least
    NARROW_MIN_WARPS warps resident per SM; else the tiled layout (weights
    once in shared memory, dW in registers) when its weights and
    32-coordinate tile fit and its dW tiles fit TILED_SLOTS; else the wide
    layout, in its rows form where a tile's rows fit a block's 227 KB, in
    its streamed form past that."""
    p = narrow_plan(widths)
    if p is not None and resident_warps(p) >= NARROW_MIN_WARPS:
        return p
    p = tiled_plan(widths)
    if p["slots"] and p["smem_bytes"] <= SMEM_LIMIT:
        return p
    for stream in (False, True):
        tile = wide.choose_tile(
            lambda t: wide_plan(widths, t, stream)["smem_bytes"], SMEM_LIMIT,
            SM_SMEM)
        if tile is not None:
            return wide_plan(widths, tile, stream)
    raise AssertionError(f"no tile of the streamed form fits: {widths}")



def chain_widths(spec) -> List[int]:
    return [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]


def supports_training(model, loss_name: str) -> bool:
    """Whether the fused train-grad kernel runs this φ model + loss: a plain
    activation chain, of any depth and width, and a kernel loss (the JAX
    package's gate, pallas_train.py:360-373)."""
    if loss_name not in LOSSES:
        return False
    spec = getattr(model, "spec", None)
    if spec is None:
        return False
    try:
        chain_layer_specs(spec)
    except ValueError:
        return False
    return True


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded as cvt.rna.tf32.f32 rounds: to 10 mantissa bits, the
    nearest, ties away from zero (inf and NaN kept)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 x as the narrow kernel feeds them to the
    tensor cores for 3xTF32 (csrc/fused_train.cu split_tf32): big = x
    rounded as cvt.rna.tf32.f32 rounds it, small = x - big (exact in
    float32) as the tensor core reads it, its 13 low bits dropped.  big +
    small is within 2^-21 |x| of x, and a b = as bb + ab bs + ab bb keeps
    float32 accuracy."""
    big = _tf32(x)
    small = (x - big).contiguous().view(torch.int32) & -0x2000
    return big, small.view(torch.float32)


def tf32_split_nearest(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 x as the tensor-core chain of kernels 2 and
    3 splits it (csrc/tf32.cuh split_tf32_nearest): big = x rounded as
    cvt.rna.tf32.f32 rounds it, small = x - big rounded the same way."""
    big = tf32_split(x)[0]
    return big, tf32_split(x - big)[0]


def pack_fragments(m: torch.Tensor, kb: int, nt: int,
                   split=tf32_split) -> torch.Tensor:
    """The (kb, nt, 32, 4) B fragments of the (K, N) matrix m as the narrow
    kernel packs them in shared memory (pack_narrow_weights): lane 4g + t
    of fragment (k, j) holds big and big, small and small of
    m[8k + 2t][8j + g] and m[8k + 2t + 1][8j + g], zeros past m, split by
    `split` (kernels 2 and 3 pass tf32_split_nearest).  The forward packs
    m = [W; b], the input gradient m = W^T."""
    full = torch.zeros(8 * kb, 8 * nt, dtype=torch.float32)
    full[:m.shape[0], :m.shape[1]] = m
    pairs = full.view(kb, 4, 2, nt, 8).permute(0, 3, 4, 1, 2)  # k j g t e
    big, small = split(pairs.reshape(kb, nt, 32, 2))
    return torch.cat([big, small], dim=-1)


def unpack_fragments(frags: torch.Tensor, rows: int, cols: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) matrices of pack_fragments' output, cut to
    (rows, cols)."""
    kb, nt = frags.shape[:2]
    out = []
    for part in (frags[..., :2], frags[..., 2:]):
        full = part.reshape(kb, nt, 8, 4, 2).permute(0, 3, 4, 1, 2)
        out.append(full.reshape(8 * kb, 8 * nt)[:rows, :cols])
    return out[0], out[1]


def _act_fwd(z: torch.Tensor, act: str, w0: float):
    """(act(z), d act/dz); None for the identity."""
    if act == "sine":
        s, c = fast_sincos(w0 * z)
        return s, w0 * c
    if act == "relu":
        return torch.clamp_min(z, 0.0), (z > 0.0).to(z.dtype)
    if act == "sigmoid":
        s = torch.sigmoid(z)
        return s, s * (1.0 - s)
    if act == "none":
        return z, None
    raise ValueError(act)


def fused_train_grads_reference(layers, coords_t, values_t, weights_t,
                                acts: LayerSpec, *, loss_name: str,
                                beta: float = 0.01, weight_thres=None,
                                unit_masks=None):
    """The kernel's function in plain PyTorch, feature-major: the forward
    stores h_l and d_l, the backward re-reads them (no autograd).

    One chain: w (fin, fout), b (fout,), coords (C, N), values / weights
    (Cout, N).  A fleet adds a leading block axis B to every one of them
    and gets a loss of shape (B,).  weight_thres: a number (0 or None
    disables the override) or a (B,) tensor (-inf disables it for that
    block).  unit_masks: None or one entry per layer, None or (f_l,) /
    (B, f_l) 0/1, multiplying h_l and d_l after the activation (a masked
    identity layer's derivative is its mask)."""
    n_layers = len(layers)
    masks = unit_masks if unit_masks is not None else [None] * n_layers
    hs, ds = [coords_t], []
    h = coords_t
    for layer, (act, w0), mk in zip(layers, acts, masks):
        z = layer["w"].transpose(-1, -2) @ h + layer["b"][..., :, None]
        h, d = _act_fwd(z, act, w0)
        if mk is not None:
            m = mk[..., :, None]
            h = h * m
            d = m if d is None else d * m
        hs.append(h)
        ds.append(d)
    pred = h
    w_eff = weights_t
    if isinstance(weight_thres, torch.Tensor):
        w_eff = torch.where(pred <= weight_thres[..., None, None], 1.0,
                            weights_t)
    elif weight_thres:
        w_eff = torch.where(pred <= weight_thres, 1.0, weights_t)
    e = pred - values_t
    if loss_name == "datal2":
        l_elem = e * e
        g = 2.0 * w_eff * e
    elif loss_name == "datasmoothl1":
        ae = e.abs()
        l_elem = torch.where(ae < beta, 0.5 * ae * ae / beta, ae - 0.5 * beta)
        g = w_eff * torch.where(ae < beta, e / beta, torch.sign(e))
    else:
        raise NotImplementedError(loss_name)
    loss = torch.sum(w_eff * l_elem, dim=(-2, -1))
    if ds[-1] is not None:
        g = g * ds[-1]
    m = float(coords_t.shape[-1] * values_t.shape[-2])
    grads: List[Dict] = [None] * n_layers
    for l in range(n_layers - 1, -1, -1):
        grads[l] = {"w": (hs[l] @ g.transpose(-1, -2)) / m,
                    "b": g.sum(dim=-1) / m}
        if l > 0:
            g = layers[l]["w"] @ g
            if ds[l - 1] is not None:
                g = g * ds[l - 1]
    return loss / m, {"layers": grads}


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------
_OCCUPANCY: Dict[Tuple[int, str, int, int, int], int] = {}


def _grid(lib, device: torch.device, p: Dict, n: int, n_fleet: int) -> int:
    """Persistent grid per fleet block: as many blocks in all as fit on the
    card at once (at least one per chain), but no more than there are
    tiles."""
    key = (device.index or 0, p["layout"], p["threads"], p["smem_bytes"],
           p.get("slots", p.get("jobs", 0)), p.get("small", False),
           p.get("stream", False))
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        from brief_pytorch_tpu_torch.ops import build
        if p["layout"] == "tiled":
            err = lib.brief_fused_train_tiled_occupancy(
                p["slots"], p["smem_bytes"], ctypes.addressof(per_sm),
                ctypes.addressof(sms))
        elif p["layout"] == "wide":
            err = lib.brief_fused_train_wide_occupancy(
                p["block"], int(p["stream"]), p["smem_bytes"],
                ctypes.addressof(per_sm), ctypes.addressof(sms))
        else:
            err = lib.brief_fused_train_occupancy(
                p["threads"], p["jobs"], int(p["small"]), p["smem_bytes"],
                ctypes.addressof(per_sm), ctypes.addressof(sms))
        build.check(err, "fused_train occupancy")
        _OCCUPANCY[key] = max(1, per_sm.value) * sms.value
    # a fleet shares the resident blocks: rounding up would start a second
    # wave of a few blocks
    per_fleet = max(1, _OCCUPANCY[key] // n_fleet)
    return max(1, min(per_fleet,
                      -(-n // (p["block"] * p.get("groups", 1)))))


def _check_batch(widths, coords, values, weights, lead: Tuple[int, ...]):
    """Shapes, device, type and contiguity of one call's batch tensors."""
    device = coords.device
    c_in, c_out = widths[0], widths[-1]
    n = coords.shape[-1]
    if tuple(coords.shape) != lead + (c_in, n):
        raise ValueError(f"coords: expected {lead + (c_in, n)}, got "
                         f"{tuple(coords.shape)}")
    for name, x in (("values", values), ("weights", weights)):
        if tuple(x.shape) != lead + (c_out, n):
            raise ValueError(f"{name}: expected {lead + (c_out, n)} matching "
                             f"coords and the last layer, got "
                             f"{tuple(x.shape)}")
    for name, x in (("coords", coords), ("values", values),
                    ("weights", weights)):
        if x.device != device or x.dtype != torch.float32 or \
                not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"on {device}")


def _layer_widths(layers, c_in: int, lead: Tuple[int, ...]) -> List[int]:
    widths = [c_in] + [int(l["w"].shape[-1]) for l in layers]
    for l, layer in enumerate(layers):
        if tuple(layer["w"].shape) != lead + (widths[l], widths[l + 1]) or \
                tuple(layer["b"].shape) != lead + (widths[l + 1],):
            raise ValueError(f"layer {l}: w {tuple(layer['w'].shape)} / b "
                             f"{tuple(layer['b'].shape)} do not chain")
    return widths


_PLANS: Dict[Tuple[int, ...], Dict] = {}
_WIDE_BUFFERS: Dict[torch.device, Tuple[Tuple[int, ...],
                                        Dict[str, torch.Tensor]]] = {}


def _wide_buffers(device: torch.device, p: Dict, n_fleet: int, np_: int,
                  grid: int, splits: int) -> Dict[str, torch.Tensor]:
    """The wide layout's device scratch: the packed weights, h_l and d_l /
    g_l of every coordinate, dW's partial rows and the loss partials.
    Kept for the last shape per device and reused by every call of that
    shape (a training run's steps); a new shape frees it first.  This
    scratch, not shared memory, bounds the layout's width: where the card
    cannot hold it, torch.cuda.OutOfMemoryError names its bytes."""
    key = (p["wp_total"], p["rows_total"], p["n_params"], n_fleet, np_,
           grid, splits)
    if device not in _WIDE_BUFFERS or _WIDE_BUFFERS[device][0] != key:
        _WIDE_BUFFERS.pop(device, None)
        shapes = {"wp": (n_fleet, p["wp_total"]),
                  "scratch": (n_fleet, p["rows_total"], np_),
                  "partial": (n_fleet, splits, p["n_params"]),
                  "lossp": (n_fleet, grid)}
        try:
            bufs = {k: torch.empty(v, dtype=torch.float32, device=device)
                    for k, v in shapes.items()}
        except torch.cuda.OutOfMemoryError as e:
            need = 4 * sum(math.prod(v) for v in shapes.values())
            raise torch.cuda.OutOfMemoryError(
                f"the train kernel's wide layout needs {need:,} bytes of "
                f"device scratch for {n_fleet} chain(s) of "
                f"{p['rows_total']:,} activation rows at N = {np_:,} "
                f"({4 * n_fleet * p['rows_total'] * np_:,} bytes of it h_l "
                f"and d_l); {device} cannot hold it: fewer coordinates a "
                f"step (Compress.sampler.sample_size) shrink it") from e
        _WIDE_BUFFERS[device] = (key, bufs)
    return _WIDE_BUFFERS[device][1]


def free_scratch() -> None:
    """Drop the wide layout's cached device scratch (the next wide call
    allocates it anew): B * rows_total * round64(N) floats, 16.8 GB for
    3-20971-1 at N = 100,000, that a run's last shape keeps otherwise."""
    _WIDE_BUFFERS.clear()


_SLOT_MAPS: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _slot_map(widths, slots: int, device: torch.device) -> torch.Tensor:
    """dw_map as an int32 tensor on `device`, made once per chain shape (a
    step's launch then moves nothing from the host)."""
    key = (tuple(widths), device)
    if key not in _SLOT_MAPS:
        _SLOT_MAPS[key] = torch.tensor(dw_map(widths, slots),
                                       dtype=torch.int32, device=device)
    return _SLOT_MAPS[key]


def narrow_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
                 mask_off: Sequence[int], ptrs: Sequence[int]) -> List[int]:
    """The narrow layout's table (csrc/fused_train.cu NarrowLayer rows,
    then the plan's dW job codes): per layer its W, b and unit mask
    pointers (ptrs, 3 a layer, 0 for no mask), widths, activation,
    offsets, store rows, mask offset (-1: none), dW orientation and w0."""
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            i64_words(ptrs[3 * l]) + i64_words(ptrs[3 * l + 1]) +
            i64_words(ptrs[3 * l + 2]) +
            [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
             p["wf_off"][l], p["kb"][l], p["nt"][l], p["wb_off"][l],
             p["kbb"][l], p["ntb"][l], p["x_row"][l], p["h_row"][l],
             p["g_row"][l], mask_off[l], p["dw_gmajor"][l], f32_word(w0)],
            NARROW_ROW_WORDS)
    return words + list(p["job_table"])


def tiled_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
                mask_off: Sequence[int]) -> List[int]:
    """The tiled layout's table (csrc/fused_train.cu TiledLayer rows)."""
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
             p["w_off"][l], p["x_row"][l], p["h_row"][l], p["g_row"][l],
             mask_off[l], f32_word(w0)], TILED_ROW_WORDS)
    return words


def wide_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
               mask_off: Sequence[int]) -> List[int]:
    """The wide layout's table (csrc/wide.cuh wide::Layer rows)."""
    tile_end = p["tile0"][1:] + [p["n_dw_tiles"]]
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
             p["wp_off"][l], p["colpad"][l], p["x_row"][l], p["h_row"][l],
             p["g_row"][l], mask_off[l], p["tile0"][l], tile_end[l],
             f32_word(w0)], WIDE_ROW_WORDS)
    return words


def _plan(widths: Sequence[int]) -> Dict:
    """choose_plan, made once per chain shape."""
    key = tuple(widths)
    if key not in _PLANS:
        _PLANS[key] = choose_plan(widths)
    return _PLANS[key]


def _launch(params, coords, values, weights, widths, acts,
            masks: Optional[torch.Tensor], mask_off: Sequence[int],
            thres: Optional[torch.Tensor], loss_name: str, beta: float
            ) -> torch.Tensor:
    """One launch for n_fleet = coords.shape[0] chains; returns
    (n_fleet, n_params + 1): the gradients in the packed layout, then the
    loss, divided by N * Cout.  params: (n_fleet, n_params) for the tiled
    and wide layouts; for the narrow one, a list per layer of (w, b, mask
    or None), which the kernel reads in place (masks is then None)."""
    from brief_pytorch_tpu_torch.ops import build

    device = coords.device
    if loss_name not in LOSSES:
        raise NotImplementedError(loss_name)
    if len(acts) != len(widths) - 1:
        raise ValueError("one (act, w0) per layer")
    p = _plan(widths)
    n_fleet, n = coords.shape[0], coords.shape[-1]
    mask_width = 0 if masks is None else masks.shape[1]
    key = (p["layout"], tuple(widths), tuple(acts), tuple(mask_off))
    if p["layout"] == "wide":
        np_, splits, chunk = dw_split(n, n_fleet, p["n_dw_tiles"])
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                mask_width, p["rows_max"], np_, p["rows_total"],
                p["wp_total"], p["n_dw_tiles"], p["pack_blocks"],
                int(p["stream"])]
        table, _ = layer_table(key, lambda: wide_table(p, widths, acts,
                                                       mask_off), device)
    elif p["layout"] == "tiled":
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                p["red_off"], p["act_off"], mask_width, p["slots"]]
        table, _ = layer_table(key, lambda: tiled_table(p, widths, acts,
                                                        mask_off), device)
    else:
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                p["stride"], p["act_off"], p["red_off"], p["jobs"],
                p["groups"], p["rows"], p["yw_row"], p["mask_sm"],
                int(p["small"])]
        ptrs = tuple(0 if x is None else x.data_ptr() for layer in params
                     for x in layer)
        table, head = layer_table(key + (ptrs,), lambda: narrow_table(
            p, widths, acts, mask_off, ptrs), device)
    meta_c = (ctypes.c_int * len(meta))(*meta)

    lib = build.library("fused_train", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        grid = _grid(lib, device, p, n, n_fleet)
        width = p["n_params"] + 1
        out = torch.empty((n_fleet, width), dtype=torch.float32,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        if p["layout"] == "wide":
            bufs = _wide_buffers(device, p, n_fleet, np_, grid, splits)
            build.check(lib.brief_fused_train_wide(
                coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
                params.data_ptr(), 0 if masks is None else masks.data_ptr(),
                0 if thres is None else thres.data_ptr(), table.data_ptr(),
                bufs["wp"].data_ptr(), bufs["scratch"].data_ptr(),
                bufs["partial"].data_ptr(), bufs["lossp"].data_ptr(),
                out.data_ptr(), n, n_fleet, meta_c,
                LOSSES.index(loss_name), float(beta), grid, p["block"],
                p["smem_bytes"], splits, chunk, stream), "fused_train wide")
            return out
        partial = torch.empty((n_fleet, grid * p.get("groups", 1), width),
                              dtype=torch.float32, device=device)
        if p["layout"] == "tiled":
            build.check(lib.brief_fused_train_tiled(
                coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
                params.data_ptr(), 0 if masks is None else masks.data_ptr(),
                0 if thres is None else thres.data_ptr(),
                _slot_map(widths, p["slots"], device).data_ptr(),
                table.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
                n_fleet, meta_c, LOSSES.index(loss_name), float(beta), grid,
                p["smem_bytes"], stream), "fused_train tiled")
            return out
        build.check(lib.brief_fused_train(
            coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
            table.data_ptr(), head,
            0 if thres is None else thres.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, n_fleet, meta_c,
            LOSSES.index(loss_name), float(beta), grid, p["threads"],
            p["smem_bytes"], stream), "fused_train")
    return out


def _unpack(out: torch.Tensor, widths: Sequence[int]):
    """(loss, grads) views of _launch's (B, n_params + 1) output."""
    grads, o = [], 0
    for fin, fout in zip(widths[:-1], widths[1:]):
        grads.append({"w": out[:, o:o + fin * fout].view(-1, fin, fout),
                      "b": out[:, o + fin * fout:o + fin * fout + fout]})
        o += fin * fout + fout
    return out[:, o], grads


_THRES: Dict[Tuple[torch.device, float], torch.Tensor] = {}


def _thres_tensor(value: float, device: torch.device) -> torch.Tensor:
    """A (1,) tensor of one chain's threshold on `device`, made once per
    value (a step's launch then moves nothing from the host)."""
    key = (device, value)
    if key not in _THRES:
        _THRES[key] = torch.full((1,), value, dtype=torch.float32,
                                 device=device)
    return _THRES[key]


def fused_train_grads(layers, coords_t: torch.Tensor, values_t: torch.Tensor,
                      weights_t: torch.Tensor, acts: LayerSpec, *,
                      loss_name: str, beta: float = 0.01, weight_thres=None):
    """(loss, grads) for weighted-loss fitting of one plain activation chain.

    layers: [{'w': (fin, fout), 'b': (fout,)}, ...] float32
    coords_t: (C, N); values_t / weights_t: (Cout, N) — feature-major,
    contiguous.  weight_thres: 0 or None disables the override.  grads:
    {"layers": [{'w', 'b'}]} shaped like `layers`, loss and grads divided
    by N * Cout.  A fleet of one: CUDA tensors launch the kernel; CPU
    tensors take the plain version.
    """
    if coords_t.device.type == "cpu":
        return fused_train_grads_reference(
            layers, coords_t, values_t, weights_t, acts,
            loss_name=loss_name, beta=beta, weight_thres=weight_thres)
    thres = None
    if weight_thres:
        thres = _thres_tensor(float(weight_thres), coords_t.device)
    loss, grads = fused_train_grads_fleet(
        [{k: v[None] for k, v in layer.items()} for layer in layers],
        coords_t[None], values_t[None], weights_t[None], acts,
        loss_name=loss_name, beta=beta, thres=thres)
    return loss[0], {"layers": [{k: v[0] for k, v in g.items()}
                                for g in grads["layers"]]}


def fused_train_grads_fleet(layers, coords: torch.Tensor,
                            values: torch.Tensor, weights: torch.Tensor,
                            acts: LayerSpec, *, loss_name: str,
                            beta: float = 0.01, unit_masks=None,
                            thres: Optional[torch.Tensor] = None):
    """(losses (B,), grads) of B padded chains in one launch (the block
    fleet's step, JAX block_trainer.py:594-617).

    layers: [{'w': (B, fin, fout), 'b': (B, fout)}, ...] float32
    coords: (B, C, N); values / weights: (B, Cout, N), contiguous.
    unit_masks: None or per layer None or (B, f_l) 0/1 (the fleet passes
    its hidden layers' masks and None for the last layer).  thres: None
    or (B,) float32, -inf where the override is disabled.  grads are
    shaped like `layers`, everything divided by N * Cout per block.  CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    """
    if coords.device.type == "cpu":
        return fused_train_grads_reference(
            layers, coords, values, weights, acts, loss_name=loss_name,
            beta=beta, weight_thres=thres, unit_masks=unit_masks)
    if not coords.is_cuda:
        raise ValueError(f"fused_train_grads runs on cuda or cpu, not "
                         f"{coords.device}")
    global launches
    n_fleet = coords.shape[0]
    widths = _layer_widths(layers, coords.shape[1], (n_fleet,))
    _check_batch(widths, coords, values, weights, (n_fleet,))
    for layer in layers:
        for t in (layer["w"], layer["b"]):
            if t.device != coords.device or t.dtype != torch.float32:
                raise ValueError(f"weights: expected float32 on "
                                 f"{coords.device}")
    mask_list, mask_off, off = [], [], 0
    for l in range(len(layers)):
        mk = None if unit_masks is None or l >= len(unit_masks) \
            else unit_masks[l]
        if mk is not None:
            if tuple(mk.shape) != (n_fleet, widths[l + 1]):
                raise ValueError(f"unit mask {l}: expected "
                                 f"{(n_fleet, widths[l + 1])}, got "
                                 f"{tuple(mk.shape)}")
            mk = mk.to(torch.float32).contiguous()
        mask_off.append(-1 if mk is None else off)
        off += 0 if mk is None else widths[l + 1]
        mask_list.append(mk)
    if _plan(widths)["layout"] == "narrow":   # read in place: no copies
        params = [(layer["w"].contiguous(), layer["b"].contiguous(), mk)
                  for layer, mk in zip(layers, mask_list)]
        masks = None
    else:
        if n_fleet == 1:    # one chain: the 1-D concatenation is the faster
            params = torch.cat([t.reshape(-1) for layer in layers
                                for t in (layer["w"], layer["b"])])[None]
        else:
            params = torch.cat([t for layer in layers
                                for t in (layer["w"].reshape(n_fleet, -1),
                                          layer["b"])], dim=1)
        rows = [mk for mk in mask_list if mk is not None]
        masks = torch.cat(rows, dim=1).contiguous() if rows else None
    if thres is not None:
        if tuple(thres.shape) != (n_fleet,) or thres.device != coords.device:
            raise ValueError(f"thres: expected ({n_fleet},) on "
                             f"{coords.device}")
        thres = thres.to(torch.float32).contiguous()
    out = _launch(params, coords, values, weights, widths, acts, masks,
                  mask_off, thres, loss_name, beta)
    launches += 1
    loss, grads = _unpack(out, widths)
    return loss, {"layers": grads}
