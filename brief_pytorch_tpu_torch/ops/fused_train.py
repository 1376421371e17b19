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
  * tiled (`tiled_plan`; the DivideTask fleets' buckets 3-66x6-1,
    3-58x6-1, 3-28x6-1, 2-47x4-1, and 5 x 64, 5 x 95, 3-9x19-1): W once in
    float32 beside a store of every layer's h and d for a tile of 16 x mt
    coordinates (`swizzle`d rows, no bank conflict); 8 warps, the warps
    of each m-tile carrying it through the layers on the tensor cores in
    3xTF32 (operands split as they are read, float32 sums per k-block),
    dW in jobs (`tiled_jobs`, `dw_map`) kept in registers for the whole
    call, written once; a fleet's chains stop at their masks' widths
    (`tiled_widths`) and share the grid by their work (`tiled_work`,
    `tiled_shares`).  Paced by instruction issue (~10 instructions an
    mma), not the tensor cores; `tiled_emulation` is its arithmetic on
    the CPU;
  * wide (`wide_plan`; the SingleTask default on the 64x512x512 demo
    volumes, 3-191x4-1 and 3-242x4-1, fleet buckets past the tiled layout
    such as 3-128x6-1, and the deep chains, 3-78x19-1): the three
    products on the tensor cores in 3xTF32, W split once a call into
    fragment-ordered packs (ops/wide.py, csrc/wide.cuh) streamed through a
    cp.async slab ring, a tile of 128 or 64 coordinates carried
    through the forward in shared memory; a device-memory scratch of one
    row set a hidden layer (its z, from which the input gradient
    recomputes h and d, writing h over z for dW) and two G buffers; per
    layer, last first, the input gradient a tile at a time and dW a
    split-K product over the coordinates (`dw_split`); `wide_emulation`
    is its arithmetic on the CPU.  It takes layers
    of up to WIDE_MAX_FEATURES features (the rows of a 64-coordinate
    tile); past that the streamed form takes the chain (ops/stream.py,
    csrc/fused_train_stream.cu; 3-4096-1, 3-20971-1, [3, 4096, 4096, 1]):
    thin end layers as reductions on the CUDA cores, the square products
    on the tensor cores in 3xTF32, one row set of z per stored hidden
    layer.  The limit of both is device memory for the scratch, which the
    wrapper reports as torch.cuda.OutOfMemoryError naming the bytes.
csrc/fused_train.cu and csrc/fused_train_stream.cu say what bounds each.

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

from brief_pytorch_tpu_torch.ops import stream as stream_form
from brief_pytorch_tpu_torch.ops import wide
from brief_pytorch_tpu_torch.ops.chain import (ACTS, LayerSpec,
                                               chain_layer_specs, f32_word,
                                               i64_words, layer_table,
                                               pad_row)
from brief_pytorch_tpu_torch.ops.fast_math import fast_sincos
from brief_pytorch_tpu_torch.ops.tc_model import (tf32_split,  # noqa: F401
                                                  tf32_split_nearest)

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
TILED_WARPS = 8              # kTiledWarps of csrc/fused_train.cu
TILED_THREADS = 32 * TILED_WARPS
TILED_MT = (8, 4, 2)         # m-tiles (16 coordinates) a tile, largest first
TILED_JOB = 3                # kTiledJob: dW tiles of one job (one A row)
TILED_JOBS = (3, 6, 9, 11, 13)   # dW jobs per warp: the kernel's instances
TILED_PI = 0x56127430        # kTiledPi: pi(r & 7), a nibble each (`swizzle`)
DW_CHUNK = 32                # kDwChunk: coordinates of a dW k-slab
WIDE_DW_BLOCKS = 264         # 16-warp dW blocks of a layer's launch: 2 waves
WIDE_MAX_FEATURES = 352      # the wide layout's widest layer: the rows of
#                              a 64-coordinate tile in 227 KB; the streamed
#                              form is faster past it (PERF.md §6)
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
    "brief_fused_train_wide_occupancy": [ctypes.c_int] * 2 + [
        ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train_wide": [ctypes.c_void_p] * 13 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
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


def _round32(x: int) -> int:
    return (x + 31) // 32 * 32


def swizzle(row, u):
    """Column of coordinate u in row `row` of the tiled layout's store
    (csrc/fused_train.cu tiled_at): u XOR 4 pi(row & 7), pi the
    permutation 0 3 4 7 2 1 6 5 of TILED_PI.  Every fragment access of
    the kernel (rows 2t, 2t + 1 or t, t + 4 of a k-block by coordinates g,
    g + 8; rows g of a dW tile by coordinates t, t + 4) then hits 32
    distinct banks, with rows of 16 x mt floats and no padding
    (tests/test_torch_fused_train_tiled.py checks it).  Integers or
    integer arrays."""
    return u ^ (((TILED_PI >> (4 * (row & 7))) & 7) << 2)


def _w_stride(fout: int) -> int:
    """Row stride of a layer's W in the tiled layout: the least >= fout
    that is 4 mod 8, so that both products' B-fragment reads hit 32
    banks."""
    return fout + (4 - fout) % 8


def tiled_jobs(widths: Sequence[int]
               ) -> List[Tuple[int, int, int, int, int]]:
    """The tiled layout's dW jobs in order, (layer, gmajor, m-tile, first
    n-tile, n-tiles): layer l's (fin + 1) x fout gradient, the bias as row
    fin, in 16 x 8 mma tiles, M over fout (gmajor 1) or over fin + 1,
    whichever gives fewer jobs (then fewer tiles); each row of tiles cut
    into jobs of up to TILED_JOB tiles, which share the row's A
    fragment."""
    jobs = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        count = lambda m, nn: (-(-m // 16) * -(-_tiles8(nn) // TILED_JOB),
                               -(-m // 16) * _tiles8(nn))
        gmajor = int(count(fout, fin + 1) <= count(fin + 1, fout))
        m, nn = (fout, fin + 1) if gmajor else (fin + 1, fout)
        for mt in range(-(-m // 16)):
            for n0 in range(0, _tiles8(nn), TILED_JOB):
                jobs.append((l, gmajor, mt, n0,
                             min(TILED_JOB, _tiles8(nn) - n0)))
    return jobs


def dw_map(p: Dict) -> List[List[Tuple[int, int, int, int, int]]]:
    """The dW jobs of plan p dealt to the TILED_WARPS warps of a block, a
    contiguous run of at most p["per_warp"] each.  Each warp keeps its
    jobs' sums in registers for the whole call."""
    jobs, k = p["dw_jobs"], p["per_warp"]
    return [jobs[w * k:(w + 1) * k] for w in range(TILED_WARPS)]


def dw_codes(p: Dict) -> List[int]:
    """dw_map as the kernel's table words: per warp, per slot (p["jobs"]
    of them, the instance), the job's store rows, A (M) and B (first
    n-tile, N), rowA | rowB << 13 | a_in << 26 | b_in << 27 (a_in, b_in:
    the row is in the tile's input buffer), and its place in the gradient,
    layer << 20 | gmajor << 19 | m-tile << 12 | first n-tile << 4 |
    n-tiles.  A slot without a job reads rows 0 (code 0) and is never
    written (-1)."""
    words = []
    for run in dw_map(p):
        for s in range(p["jobs"]):
            if s >= len(run):
                words += [0, -1]
                continue
            l, gm, mt, n0, cnt = run[s]
            xr, gr = p["x_row"][l], p["g_row"][l]
            xin = int(l == 0)
            ra, rb = (gr, xr) if gm else (xr, gr)
            ia, ib = (0, xin) if gm else (xin, 0)
            words += [ra + 16 * mt | (rb + 8 * n0) << 13 | ia << 26
                      | ib << 27,
                      l << 20 | gm << 19 | mt << 12 | n0 << 4 | cnt]
    return words


TILED_DW_WEIGHT = 3           # kTiledDwWeight of csrc/fused_train.cu


def tiled_widths(widths: Sequence[int], masks) -> List[int]:
    """Each layer's width as the tiled kernel's products see it for one
    chain (csrc/fused_train.cu tiled_width): one past the last unit whose
    mask is not 0, or fout where the layer has no mask (masks[l] None)."""
    out = []
    for l, fout in enumerate(widths[1:]):
        m = None if masks is None or l >= len(masks) else masks[l]
        if m is None:
            out.append(fout)
            continue
        nz = torch.nonzero(torch.as_tensor(m).reshape(-1) != 0)
        out.append(int(nz.max()) + 1 if len(nz) else 0)
    return out


def tiled_work(c_in: int, widths_eff: Sequence[int], jobs: int) -> int:
    """A chain's work per tile in (k-block, n-tile) pairs of its products,
    plus its dW jobs at TILED_DW_WEIGHT each (csrc/fused_train.cu
    tiled_work): the measure tiled_shares divides the grid by."""
    w, fin = TILED_DW_WEIGHT * jobs * TILED_WARPS, c_in
    for l, fout in enumerate(widths_eff):
        w += ((fin + 8) >> 3) * ((fout + 7) >> 3)
        if l > 0:
            w += ((fout + 7) >> 3) * ((fin + 7) >> 3)
        fin = fout
    return w


def tiled_shares(work: Sequence[int], blocks: int, n_tiles: int
                 ) -> List[Tuple[int, int]]:
    """(first block, blocks) of each chain: the grid's `blocks` shared by
    the chains' `work`, each at least 1 and at most n_tiles; the rest one
    at a time to the chain with the most work a block, any excess back
    from the one with the least (csrc/fused_train.cu tiled_share_kernel,
    the same integer steps)."""
    total = sum(work)
    cnt = [min(max(blocks * w // total, 1), n_tiles) for w in work]
    used = sum(cnt)
    while used < blocks:
        best = -1
        for c, w in enumerate(work):
            if cnt[c] < n_tiles and (best < 0 or
                                     w * cnt[best] > work[best] * cnt[c]):
                best = c
        if best < 0:
            break
        cnt[best] += 1
        used += 1
    while used > blocks:
        best = -1
        for c, w in enumerate(work):
            if cnt[c] > 1 and (best < 0 or
                               w * cnt[best] < work[best] * cnt[c]):
                best = c
        cnt[best] -= 1
        used -= 1
    first = [sum(cnt[:c]) for c in range(len(cnt))]
    return list(zip(first, cnt))


def tiled_plan(widths: Sequence[int], mt: Optional[int] = None) -> Dict:
    """Shared-memory layout (in floats) of the tiled layout for tiles of
    16 x mt coordinates (mt m-tiles; None: the largest of TILED_MT that
    fits SMEM_LIMIT, else the smallest).

    W of every layer once in float32, (fin + 1) rows with the bias as row
    0, row stride w_stride (`_w_stride`: >= fout, 4 mod 8), the layers
    back to back and zeros after them up to the last float the products
    read (`w_floats`): a product's padded k-block or n-tile reads the next
    rows, which hold finite weights times zero activations, or output
    columns it drops.  Then the activation store, rows of 16 x mt floats
    (one per coordinate of the tile, `swizzle`d): two input buffers of
    buf_rows rows (a ones row, the coordinates, zeros to 8; the values and
    weights from yw_row), the tile's and the next one's; then per layer
    its h (hidden layers: fout + 1 rows, the first one ones, the next
    layer's bias input) and its d / g (fout rows), each region
    starting on a row multiple of 8 and zero-padded to it, and rows past
    them where a dW job's tiles reach.  Then the unit masks (mask_sm),
    the layer table's copy (tab_sm), the chain's widths (width_sm,
    `tiled_widths`), the dW codes (`dw_codes`,
    TILED_WARPS x jobs words) and one float a warp for the loss.  `jobs`:
    the kernel instance, the least of TILED_JOBS that holds `per_warp`
    dW jobs (0: none does)."""
    if mt is None:
        fits = [m for m in TILED_MT
                if tiled_plan(widths, m)["smem_bytes"] <= SMEM_LIMIT]
        return tiled_plan(widths, fits[0] if fits else TILED_MT[-1])
    n_layers = len(widths) - 1
    c_in, c_out = widths[0], widths[-1]
    n_params, p_off, w_off, w_stride = 0, [], [], []
    off, reach = 0, 0
    for fin, fout in zip(widths[:-1], widths[1:]):
        p_off.append(n_params)
        n_params += (fin + 1) * fout
        s = _w_stride(fout)
        w_off.append(off)
        w_stride.append(s)
        # forward rows < round8(fin + 1), input gradient rows 1 ..
        # round8(fin), columns < round8(fout)
        reach = max(reach, off + max(_round8(fin + 1) - 1, _round8(fin)) * s
                    + _round8(fout))
        off += (fin + 1) * s
    w_floats = _round32(max(off, reach))
    in_rows = _round8(c_in + 1)
    buf_rows = in_rows + _round8(2 * c_out)
    row = 2 * buf_rows
    x_row, h_row, g_row = [0], [], []
    for l in range(n_layers):
        fout = widths[l + 1]
        if l < n_layers - 1:
            h_row.append(row)
            x_row.append(row)
            row += _round8(fout + 1)
        else:
            h_row.append(-1)
        g_row.append(row)
        row += _round8(fout)
    # dW jobs read 16-row m-tiles and TILED_JOB 8-row n-tiles of the
    # 8-row-aligned regions: rows past the last region where they reach
    jobs = tiled_jobs(widths)
    reach_rows = row
    for l, gm, mt_, n0, _ in jobs:
        ra, rb = (g_row[l], x_row[l]) if gm else (x_row[l], g_row[l])
        reach_rows = max(reach_rows, ra + 16 * mt_ + 16,
                         rb + 8 * (n0 + TILED_JOB))
    store_rows = reach_rows
    block = 16 * mt
    mask_sm = w_floats + store_rows * block
    tab_sm = mask_sm + _round4(sum(widths[1:]))
    width_sm = tab_sm + n_layers * TILED_ROW_WORDS
    desc_sm = width_sm + _round4(n_layers)
    per_warp = -(-len(jobs) // TILED_WARPS)
    k = next((j for j in TILED_JOBS if per_warp <= j), 0)
    red_off = desc_sm + _round4(TILED_WARPS * max(k, 1))
    return {"layout": "tiled", "n_params": n_params, "p_off": p_off,
            "w_off": w_off, "w_stride": w_stride, "w_floats": w_floats,
            "mt": mt, "block": block, "threads": TILED_THREADS,
            "buf_rows": buf_rows, "yw_row": in_rows, "x_row": x_row,
            "h_row": h_row, "g_row": g_row, "store_rows": store_rows,
            "mask_sm": mask_sm, "tab_sm": tab_sm, "width_sm": width_sm,
            "desc_sm": desc_sm,
            "dw_jobs": jobs, "per_warp": per_warp, "jobs": k,
            "red_off": red_off, "smem_bytes": 4 * (red_off + TILED_WARPS)}


def wide_plan(widths: Sequence[int], tile: int) -> Dict:
    """Layout of the wide layout (csrc/fused_train.cu wide_tile_kernel,
    wide_dw_kernel) for a chain of `widths` and `tile` coordinates a tile
    (wide.THREADS threads).

    Shared memory (wide.smem_bytes): two buffers of rows_max rows of
    `tile` floats, the slab ring, one float a thread for the loss.  The
    packs (wide.layer_meta): per layer W (wf_off) and W^T (wb_off) in
    split mma fragments.  Scratch rows (np = round128(N) floats each; B *
    rows_total of them a call): the coordinates (rows 0 .. c_in - 1), one
    row set a hidden layer, out_row[l], where its output z_{l+1} lives
    until the input gradient writes h_{l+1} over it (-1 for the last
    layer), and two G buffers of the widest layer's rows, g_row[l] the
    one holding g_{l+1} (the last layer's g_L in the first, then
    alternating); in_row[l] is the layer's input (0: the coordinates).
    dW: per layer wide.dw_tiles blocks of (wide.OB_I, wide.OB_O) entries of
    its fin x fout gradient of W."""
    n_layers = len(widths) - 1
    out_row, row = [], widths[0]
    for l, f in enumerate(widths[1:]):
        out_row.append(row if l < n_layers - 1 else -1)
        row += f if l < n_layers - 1 else 0
    gw = max(widths[1:])
    g_row = [row + gw * ((n_layers - 1 - l) % 2) for l in range(n_layers)]
    kp = wide.kp(tile)
    pack = max(wide.pack_floats(a, b, kp) + wide.pack_floats(b, a, kp)
               for a, b in zip(widths[:-1], widths[1:])) // 4
    return {"layout": "wide", "block": tile, "threads": wide.THREADS,
            "stream": False, "kp": kp,
            "rows_max": wide.rows_max(widths, tile),
            "rows_total": row + 2 * gw, "out_row": out_row,
            "in_row": [0] + out_row[:-1], "g_row": g_row,
            "dw_tiles": [wide.dw_tiles(a, b)
                         for a, b in zip(widths[:-1], widths[1:])],
            "pack_blocks": min(1024, -(-pack // 256)),
            **wide.layer_meta(widths, kp),
            "smem_bytes": wide.smem_bytes(widths, tile)}


def dw_split(n: int, n_fleet: int, widths: Sequence[int]) -> Dict:
    """The wide layout's dW sums at N = n: np = round128(n) and per layer
    its splits of the coordinates [0, np) (`chunk` of them a split, a
    multiple of DW_CHUNK; the last split ends at np), so that a layer's
    launch holds at most two waves of blocks (WIDE_DW_BLOCKS of 16 warps,
    twice as many of 8), at least 256 coordinates a split; its partial
    sums' offset (part_off: (fin + 1) * fout floats a
    split) and part_total floats of them a chain."""
    np_ = wide.round_up(n, 128)
    splits, chunks, part_off, off = [], [], [], 0
    for fin, fout in zip(widths[:-1], widths[1:]):
        ti, to = wide.dw_tiles(fin, fout)
        # two waves of blocks: one of 16 warps an SM, or two of 8
        aim = WIDE_DW_BLOCKS * (2 if wide.dw_columns(fout) == 64 else 1)
        s = max(1, min(aim // (ti * to * n_fleet), np_ // 256))
        chunk = wide.round_up(-(-np_ // s), DW_CHUNK)
        splits.append(-(-np_ // chunk))
        chunks.append(chunk)
        part_off.append(off)
        off += splits[-1] * (fin + 1) * fout
    return {"np": np_, "splits": splits, "chunk": chunks,
            "part_off": part_off, "part_total": off}


def wide_choose(widths: Sequence[int]) -> Optional[Dict]:
    """The wide layout's plan at the tile wide.choose_tile picks, or None
    where a layer is wider than WIDE_MAX_FEATURES or no tile fits."""
    if max(widths) > WIDE_MAX_FEATURES:
        return None
    tile = wide.choose_tile(widths, SMEM_LIMIT, SM_SMEM)
    return None if tile is None else wide_plan(widths, tile)


def choose_plan(widths: Sequence[int]) -> Dict:
    """The layout for a chain of any depth and width: the narrow layout
    (W, W^T and the activation store of a block's coordinates in shared
    memory, products on the tensor cores) when it keeps at least
    NARROW_MIN_WARPS warps resident per SM; else the tiled layout (weights
    once in shared memory, dW in registers) when its weights and a tile
    of at least 32 coordinates fit and its dW jobs fit TILED_JOBS; else
    the wide layout up to WIDE_MAX_FEATURES features a layer; else its
    streamed form (ops/stream.py stream_plan)."""
    p = narrow_plan(widths)
    if p is not None and resident_warps(p) >= NARROW_MIN_WARPS:
        return p
    p = tiled_plan(widths)
    if p["jobs"] and p["smem_bytes"] <= SMEM_LIMIT:
        return p
    p = wide_choose(widths)
    if p is not None:
        return p
    return stream_form.stream_plan(widths)


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


def _kblock_sums(a: torch.Tensor, b: torch.Tensor, split_a=tf32_split_nearest,
                 split_b=tf32_split_nearest) -> torch.Tensor:
    """(..., KB, M, N): per k-block of 8, the 3xTF32 products of a (..., M,
    K) and b (..., K, N), split by split_a and split_b, a_small b_big +
    a_big b_small + a_big b_big summed exactly and rounded to float32 (one
    k-block's three mma.sync, which truncate instead; within the
    tolerances)."""
    k = a.shape[-1]
    kp = -(-k // 8) * 8
    a = torch.nn.functional.pad(a.float(), (0, kp - k))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, kp - k))
    ab, as_ = (x.double() for x in split_a(a.contiguous()))
    bb, bs = (x.double() for x in split_b(b.contiguous()))
    blk = lambda x: x.unflatten(-1, (kp // 8, 8)).movedim(-2, -3)
    blk_b = lambda x: x.unflatten(-2, (kp // 8, 8))
    aa, asb = blk(ab), blk(as_)                      # (..., KB, M, 8)
    bbb, bsb = blk_b(bb), blk_b(bs)                  # (..., KB, 8, N)
    d = asb @ bbb + aa @ bsb + aa @ bbb
    return d.float()


def _sum_in_order(d: torch.Tensor, dim: int) -> torch.Tensor:
    """d summed along `dim` one slice after another in float32, the order
    of a kernel's accumulator."""
    acc = torch.zeros_like(d.select(dim, 0))
    for i in range(d.shape[dim]):
        acc = acc + d.select(dim, i)
    return acc


def tiled_emulation(layers, coords, values, weights, acts: LayerSpec, *,
                    loss_name: str, beta: float = 0.01, thres=None,
                    unit_masks=None, mt: int = 2, blocks: int = 1):
    """The tiled layout's arithmetic (csrc/fused_train.cu
    fused_train_tiled_kernel) on the CPU, for a fleet shaped as
    fused_train_grads_fleet takes it (thres: None or (B,), -inf for none).

    Every product in 3xTF32 on k-blocks of 8 (`_kblock_sums`): the forward
    [h, 1] [W; b] and the input gradient g W^T over the features, each
    k-block's sum added to a float32 accumulator in order; dW = [h, 1]^T
    g over the coordinates, in k-blocks of 8 coordinates of tiles of 16 mt,
    tile j going to block j % blocks, each block adding its k-blocks in
    order into its partial sums, the blocks' partials then added in order
    (reduce_partials_kernel) and divided by N * Cout.  The loss is summed
    in float64 per block, then in float32 over the blocks."""
    n_layers = len(layers)
    masks = unit_masks if unit_masks is not None else [None] * n_layers
    nb, _, n = coords.shape
    c_out = values.shape[1]
    x = coords.transpose(1, 2).float()                     # (B, N, C)
    ones = torch.ones(nb, n, 1)
    hs, ds = [], []
    for l, (layer, (act, w0)) in enumerate(zip(layers, acts)):
        h_aug = torch.cat([x, ones], dim=2)
        hs.append(h_aug)
        w_aug = torch.cat([layer["w"], layer["b"][:, None]], dim=1)
        z = _sum_in_order(_kblock_sums(h_aug[:, None], w_aug[:, None])[:, 0],
                          1)
        x, dv = _act_fwd(z, act, w0)
        if dv is None:
            dv = torch.ones_like(z)
        if masks[l] is not None:
            m = masks[l][:, None, :].float()
            x, dv = x * m, dv * m
        ds.append(dv)
    pred, y = x, values.transpose(1, 2)
    wv = weights.transpose(1, 2)
    weff = wv if thres is None else torch.where(
        pred <= thres[:, None, None], 1.0, wv)
    e = pred - y
    if loss_name == "datal2":
        l_elem, g = e * e, 2.0 * weff * e
    else:
        ae = e.abs()
        l_elem = torch.where(ae < beta, 0.5 * ae * ae / beta, ae - 0.5 * beta)
        g = weff * torch.where(ae < beta, e / beta, torch.sign(e))
    g = g * ds[-1]
    T = 16 * mt
    n_tiles = -(-n // T)
    pad = n_tiles * T - n
    owner = torch.arange(n_tiles) % blocks                 # tile -> block
    lossb = (weff * l_elem).sum(-1).double()               # (B, N)
    lossb = torch.nn.functional.pad(lossb, (0, pad)).view(nb, n_tiles, T)
    per_block = torch.stack([lossb[:, owner == k].sum((1, 2)).float()
                             for k in range(blocks)], 1)
    m = float(n * c_out)
    loss = _sum_in_order(per_block, 1) / m
    grads = [None] * n_layers
    for l in range(n_layers - 1, -1, -1):
        hp = torch.nn.functional.pad(hs[l], (0, 0, 0, pad))   # (B, Np, fin+1)
        gp = torch.nn.functional.pad(g, (0, 0, 0, pad))       # (B, Np, fout)
        d = _kblock_sums(hp.transpose(1, 2)[:, None], gp[:, None])[:, 0]
        d = d.view(nb, n_tiles, T // 8, *d.shape[-2:])        # per tile
        parts = []
        for k in range(blocks):
            mine = d[:, owner == k].flatten(1, 2)             # its k-blocks
            parts.append(_sum_in_order(mine, 1) if mine.shape[1] else
                         torch.zeros(nb, *d.shape[-2:]))
        dw = _sum_in_order(torch.stack(parts, 1), 1) / m
        grads[l] = {"w": dw[:, :-1], "b": dw[:, -1]}
        if l > 0:
            g = _sum_in_order(_kblock_sums(
                g[:, None], layers[l]["w"].transpose(1, 2)[:, None])[:, 0], 1)
            g = g * ds[l - 1]
    return loss, {"layers": grads}


def wide_emulation(layers, coords, values, weights, acts: LayerSpec, *,
                   loss_name: str, beta: float = 0.01, thres=None,
                   unit_masks=None):
    """The wide layout's arithmetic (csrc/fused_train.cu wide_tile_kernel,
    wide_dw_kernel, reduce_wide_kernel) on the CPU, for a fleet shaped as
    fused_train_grads_fleet takes it (thres: None or (B,), -inf for none).

    Every product in 3xTF32 on k-blocks of 8 (`_kblock_sums`): the
    activation or gradient operand split as it is read (tf32_split, its
    small part truncated by the tensor core), W from the packs
    (tf32_split_nearest, ops/wide.py pack_layer).  Forward: z_{l+1} = the
    k-blocks of h_l W_l added in order in float32, then the bias; z is
    what the scratch keeps, and h = act(z) m, d = act'(z) m are
    recomputed from it (fast_sincos) wherever they are read.  The loss
    and g_L per coordinate; g_l = (the k-blocks of g_{l+1} W_l^T, in
    order) d_l.  dW_l = h_l^T g_{l+1} over the coordinates [0, np), np =
    round128(N) (zeros past N), per split of `dw_split`: each
    32-coordinate chunk's four k-blocks summed from zero, the chunks added
    to the split's sum in order, the splits added in order, then divided
    by N * Cout; db the same with each chunk's sum that of its quarters of
    8 coordinates, each summed in order, added as (q0 + q1) + (q2 + q3)
    (float32 adds).  The loss is summed in float64 and rounded (the kernel's
    per-thread float32 sums differ in the last bits)."""
    n_layers = len(layers)
    masks = list(unit_masks) if unit_masks is not None else []
    masks += [None] * (n_layers - len(masks))
    nb, c_in, n = coords.shape
    widths = [c_in] + [int(l["w"].shape[-1]) for l in layers]
    sp = dw_split(n, nb, widths)
    c_out = widths[-1]
    x = coords.transpose(1, 2).float()                     # (B, N, C)

    def h_d(l, z):                 # h, d of layer l's output z (B, N, f)
        h, d = _act_fwd(z, *acts[l])
        if d is None:
            d = torch.ones_like(z)
        if masks[l] is not None:
            m = masks[l][:, None, :].float()
            h, d = h * m, d * m
        return h, d

    def product(a, b):             # a (B, M, K) b (B, K, N), k-blocks in order
        return _sum_in_order(_kblock_sums(a[:, None], b[:, None], tf32_split,
                                          tf32_split_nearest)[:, 0], 1)

    zs, h = [None], x
    for l, layer in enumerate(layers):
        z = product(h, layer["w"].float()) + layer["b"][:, None, :].float()
        zs.append(z)
        h = h_d(l, z)[0]
    pred, dv = h_d(n_layers - 1, zs[-1])
    y, wv = values.transpose(1, 2), weights.transpose(1, 2)
    weff = wv if thres is None else torch.where(
        pred <= thres[:, None, None], 1.0, wv)
    e = pred - y
    if loss_name == "datal2":
        l_elem, g = e * e, 2.0 * weff * e
    else:
        ae = e.abs()
        l_elem = torch.where(ae < beta, 0.5 * ae * ae / beta, ae - 0.5 * beta)
        g = weff * torch.where(ae < beta, e / beta, torch.sign(e))
    g = g * dv
    m = float(n * c_out)
    loss = ((weff * l_elem).double().sum((1, 2)).float() / m)
    pad = sp["np"] - n
    grads = [None] * n_layers
    for l in range(n_layers - 1, -1, -1):
        hl = x if l == 0 else h_d(l - 1, zs[l])[0]
        hp = torch.nn.functional.pad(hl, (0, 0, 0, pad))      # (B, np, fin)
        gp = torch.nn.functional.pad(g, (0, 0, 0, pad))       # (B, np, fout)
        d = _kblock_sums(hp.transpose(1, 2)[:, None], gp[:, None],
                         tf32_split, tf32_split)[:, 0]       # (B, KB, ., .)
        d = d.view(nb, -1, DW_CHUNK // 8, *d.shape[-2:])
        chunks = _sum_in_order(d, 2)                          # per chunk
        quarter = gp.view(nb, -1, 4, DW_CHUNK // 4, gp.shape[-1])
        q = _sum_in_order(quarter, 3)                         # (B, C, 4, fout)
        bchunks = (q[:, :, 0] + q[:, :, 1]) + (q[:, :, 2] + q[:, :, 3])
        per = sp["chunk"][l] // DW_CHUNK
        parts = [_sum_in_order(chunks[:, k:k + per], 1)
                 for k in range(0, chunks.shape[1], per)]
        bparts = [_sum_in_order(bchunks[:, k:k + per], 1)
                  for k in range(0, bchunks.shape[1], per)]
        grads[l] = {"w": _sum_in_order(torch.stack(parts, 1), 1) / m,
                    "b": _sum_in_order(torch.stack(bparts, 1), 1) / m}
        if l > 0:
            g = product(g, layers[l]["w"].float().transpose(1, 2)) * \
                h_d(l - 1, zs[l])[1]
    return loss, {"layers": grads}


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------
_OCCUPANCY: Dict[Tuple[int, str, int, int, int], int] = {}


def _grid(lib, device: torch.device, p: Dict, n: int, n_fleet: int) -> int:
    """Persistent grid per fleet block: as many blocks in all as fit on the
    card at once (at least one per chain), but no more than there are
    tiles; the tiled layout's, the whole grid (its kernel shares it among
    the chains)."""
    key = (device.index or 0, p["layout"], p["threads"], p["smem_bytes"],
           p.get("jobs", 0), p.get("small", False))
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        from brief_pytorch_tpu_torch.ops import build
        if p["layout"] == "tiled":
            err = lib.brief_fused_train_tiled_occupancy(
                p["jobs"], p["smem_bytes"], ctypes.addressof(per_sm),
                ctypes.addressof(sms))
        elif p["layout"] == "wide":
            err = lib.brief_fused_train_wide_occupancy(
                p["block"], p["smem_bytes"], ctypes.addressof(per_sm),
                ctypes.addressof(sms))
        else:
            err = lib.brief_fused_train_occupancy(
                p["threads"], p["jobs"], int(p["small"]), p["smem_bytes"],
                ctypes.addressof(per_sm), ctypes.addressof(sms))
        build.check(err, "fused_train occupancy")
        _OCCUPANCY[key] = max(1, per_sm.value) * sms.value
    n_tiles = -(-n // (p["block"] * p.get("groups", 1)))
    if p["layout"] == "tiled":   # one grid, shared among the chains
        return max(n_fleet, min(_OCCUPANCY[key], n_fleet * n_tiles))
    # a fleet shares the resident blocks: rounding up would start a second
    # wave of a few blocks
    per_fleet = max(1, _OCCUPANCY[key] // n_fleet)
    return max(1, min(per_fleet, n_tiles))


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


def _wide_buffers(device: torch.device, p: Dict, n_fleet: int, sp: Dict,
                  grid: int) -> Dict[str, torch.Tensor]:
    """The wide layout's device scratch: the packs, one z / g row set a
    layer for every coordinate, dW's partial sums and the loss partials.
    Kept for the last shape per device and reused by every call of that
    shape (a training run's steps); a new shape frees it first.  This
    scratch, not shared memory, bounds the layout's depth: where the card
    cannot hold it, torch.cuda.OutOfMemoryError names its bytes."""
    key = (p["wp_total"], p["rows_total"], n_fleet, sp["np"],
           sp["part_total"], grid)
    if device not in _WIDE_BUFFERS or _WIDE_BUFFERS[device][0] != key:
        _WIDE_BUFFERS.pop(device, None)
        shapes = {"wp": (n_fleet, p["wp_total"]),
                  "scratch": (n_fleet, p["rows_total"], sp["np"]),
                  "partial": (n_fleet, sp["part_total"]),
                  "lossp": (n_fleet, grid)}
        try:
            bufs = {k: torch.empty(v, device=device, dtype=torch.float64
                                   if k == "lossp" else torch.float32)
                    for k, v in shapes.items()}
        except torch.cuda.OutOfMemoryError as e:
            need = 4 * sum(math.prod(v) for v in shapes.values())
            raise torch.cuda.OutOfMemoryError(
                f"the train kernel's wide layout needs {need:,} bytes of "
                f"device scratch for {n_fleet} chain(s) of "
                f"{p['rows_total']:,} activation rows at N = {sp['np']:,} "
                f"({4 * n_fleet * p['rows_total'] * sp['np']:,} bytes of it "
                f"z and g); {device} cannot hold it: fewer coordinates a "
                f"step (Compress.sampler.sample_size) shrink it") from e
        _WIDE_BUFFERS[device] = (key, bufs)
    return _WIDE_BUFFERS[device][1]


def free_scratch() -> None:
    """Drop the wide layout's and the streamed form's cached device
    scratch (the next call allocates it anew), which a run's last shape
    keeps otherwise."""
    _WIDE_BUFFERS.clear()
    stream_form.free_buffers()


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
    """The tiled layout's table (csrc/fused_train.cu TiledLayer rows: widths,
    activation, offsets, W stride, store rows, mask offset, w0, whether
    the input is the tile's input buffer), then its dW codes
    (`dw_codes`)."""
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
             p["w_off"][l], p["w_stride"][l], p["x_row"][l], p["h_row"][l],
             p["g_row"][l], mask_off[l], f32_word(w0), int(l == 0)],
            TILED_ROW_WORDS)
    return words + dw_codes(p)


def wide_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
               mask_off: Sequence[int], sp: Dict) -> List[int]:
    """The wide layout's table (csrc/wide.cuh wide::Layer rows: widths,
    activation, offsets, packs, scratch rows, mask offset, the dW partial
    sums' offset, splits and chunk, w0, the G buffer of g_{l+1}); the
    streamed form has its own (ops/stream.py stream_table)."""
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
             p["wf_off"][l], p["wb_off"][l], p["out_row"][l],
             p["in_row"][l], mask_off[l], sp["part_off"][l],
             sp["splits"][l], sp["chunk"][l], f32_word(w0), p["g_row"][l]],
            WIDE_ROW_WORDS)
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
    if p.get("stream"):
        return stream_form.launch(p, params, coords, values, weights, widths,
                             acts, masks, mask_off, thres,
                             LOSSES.index(loss_name), beta)
    n_fleet, n = coords.shape[0], coords.shape[-1]
    mask_width = 0 if masks is None else masks.shape[1]
    key = (p["layout"], tuple(widths), tuple(acts), tuple(mask_off))
    if p["layout"] == "wide":
        sp = dw_split(n, n_fleet, widths)
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                mask_width, sp["np"], p["rows_total"], p["wp_total"],
                sp["part_total"], p["rows_max"], p["pack_blocks"]]
        table, head = layer_table(key + (sp["np"], n_fleet), lambda:
                                  wide_table(p, widths, acts, mask_off, sp),
                                  device)
    elif p["layout"] == "tiled":
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                mask_width, p["mt"], p["buf_rows"], p["yw_row"],
                p["w_floats"], p["mask_sm"], p["tab_sm"], p["width_sm"],
                p["desc_sm"], p["red_off"], p["jobs"]]
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
            bufs = _wide_buffers(device, p, n_fleet, sp, grid)
            build.check(lib.brief_fused_train_wide(
                coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
                params.data_ptr(), 0 if masks is None else masks.data_ptr(),
                0 if thres is None else thres.data_ptr(), table.data_ptr(),
                ctypes.addressof(head), bufs["wp"].data_ptr(),
                bufs["scratch"].data_ptr(), bufs["partial"].data_ptr(),
                bufs["lossp"].data_ptr(), out.data_ptr(), n, n_fleet, meta_c,
                LOSSES.index(loss_name), float(beta), grid, p["block"],
                p["smem_bytes"], stream), "fused_train wide")
            return out
        if p["layout"] == "tiled":
            # the grid's blocks shared among the chains by their work
            partial = torch.empty((grid, width), dtype=torch.float32,
                                  device=device)
            span = torch.empty(2 * n_fleet, dtype=torch.int32, device=device)
            build.check(lib.brief_fused_train_tiled(
                coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
                params.data_ptr(), 0 if masks is None else masks.data_ptr(),
                0 if thres is None else thres.data_ptr(),
                table.data_ptr(), partial.data_ptr(), span.data_ptr(),
                out.data_ptr(), n,
                n_fleet, meta_c, LOSSES.index(loss_name), float(beta), grid,
                p["smem_bytes"], stream), "fused_train tiled")
            return out
        partial = torch.empty((n_fleet, grid * p.get("groups", 1), width),
                              dtype=torch.float32, device=device)
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
