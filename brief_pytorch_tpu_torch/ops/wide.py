"""The Python side of csrc/wide.cuh: the weight packing and the shared-
memory geometry of the train kernel's wide layout (ops/fused_train.py
`wide_plan`), for chains whose weights do not fit in shared memory.

A block of THREADS threads takes a tile of T coordinates (one of TILES)
and holds two buffers of activation rows (rows_max(widths) rows of T
floats) and a ring of STAGES weight slabs.  The weights
stay in device memory, packed once per call into mma.sync B fragments
already split into TF32 big and small halves (`pack_layer`): per layer a
forward pack of W (fin x fout; the bias is added after the product) and
an input-gradient pack of W^T (fout x fin), each cut into chunks of NC
output columns, a chunk's k-blocks of 8 rows in order, 8 fragments a
k-block.  A slab is KS(T) k-blocks of one chunk.  Chains whose rows do
not fit take the streamed form (ops/stream.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from brief_pytorch_tpu_torch.ops.tc_model import tf32_split_nearest

THREADS = 512            # kThreads: 16 warps a block
NC = 64                  # kNC: output columns of a chunk (8 n-tiles)
FRAG = 128               # floats of one packed B fragment (32 lanes x 4)
STAGES = 3               # kStages: slabs in the ring
TILES = (128, 64)        # coordinates per tile: the kernel's instances
OB_I, OB_O = 64, 128     # kDwI, DwGeom<512>::kO: a dW tile, rows x columns


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def ks(tile: int) -> int:
    """k-blocks of a slab (WideSlab::kKS): 2 at 128 coordinates a tile, 4
    at 64."""
    return 2 if tile == 128 else 4


def kp(tile: int) -> int:
    """The k extent's multiple of the packs and rows: a slab's rows,
    8 ks(tile)."""
    return 8 * ks(tile)


def rows_max(widths: Sequence[int], tile: int) -> int:
    """Rows of one activation buffer: a product's operand rows (a layer's
    input in the forward, its output's g in the input gradient),
    zero-padded to kp(tile)."""
    return max(round_up(w, kp(tile)) for w in widths)


def smem_bytes(widths: Sequence[int], tile: int) -> int:
    """Dynamic shared memory of a block: two buffers of rows_max rows of
    `tile` floats and the slab ring (which at the end holds the loss
    reduction)."""
    return 4 * (2 * rows_max(widths, tile) * tile
                + STAGES * ks(tile) * 8 * FRAG)


def pack_floats(k: int, n: int, kp_: int) -> int:
    """Floats of one pack of a (k, n) matrix: k padded to a multiple of
    kp_, n to one of NC, big and small."""
    return 2 * round_up(k, kp_) * round_up(n, NC)


def packed_layout(widths: Sequence[int], kp_: int
                  ) -> Tuple[List[int], List[int], int]:
    """(wf_off, wb_off, total): float offsets of each layer's forward and
    input-gradient packs in one chain's packed copy, and its size."""
    wf, wb, off = [], [], 0
    for fin, fout in zip(widths[:-1], widths[1:]):
        wf.append(off)
        off += pack_floats(fin, fout, kp_)
        wb.append(off)
        off += pack_floats(fout, fin, kp_)
    return wf, wb, off


def pack_layer(m: torch.Tensor, kp_: int) -> torch.Tensor:
    """The pack of a (K, N) matrix m as pack_weights_kernel writes it:
    (chunks, K' / 8, 8, 32, 4) floats (K' = K padded to a multiple of
    kp_), chunk c, k-block kb,
    fragment j, lane 4 g + t holding big(b0), big(b1), small(b0),
    small(b1) of b0 = m[8 kb + t][64 c + 8 j + g], b1 = m[8 kb + t + 4][.]
    (zeros past m), split by tf32_split_nearest."""
    k, n = m.shape
    kp, np_ = round_up(k, kp_), round_up(n, NC)
    full = torch.zeros(kp, np_, dtype=torch.float32)
    full[:k, :n] = m
    # rows 8 kb + 4 e + t, columns 64 c + 8 j + g
    v = full.view(kp // 8, 2, 4, np_ // NC, 8, 8)        # kb e t c j g
    v = v.permute(3, 0, 4, 5, 2, 1)                      # c kb j g t e
    big, small = tf32_split_nearest(v.reshape(np_ // NC, kp // 8, 8, 32, 2))
    return torch.cat([big, small], dim=-1)


def unpack_layer(pack: torch.Tensor, k: int, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) matrices of pack_layer's output, cut to (k, n)."""
    c, kb = pack.shape[:2]
    out = []
    for part in (pack[..., :2], pack[..., 2:]):
        v = part.reshape(c, kb, 8, 8, 4, 2).permute(1, 5, 4, 0, 2, 3)
        out.append(v.reshape(8 * kb, c * NC)[:k, :n])
    return out[0], out[1]


def choose_tile(widths: Sequence[int], smem_limit: int,
                sm_smem: int) -> Optional[int]:
    """The tile that keeps the most coordinates resident per SM (ties to
    the larger tile), among those whose block fits `smem_limit`; None
    when none does."""
    best, best_resident = None, 0
    for tile in TILES:
        b = smem_bytes(widths, tile)
        if b > smem_limit:
            continue
        resident = tile * min(1, sm_smem // (b + 1024))   # 128 registers
        if resident > best_resident:
            best, best_resident = tile, resident
    return best


def layer_meta(widths: Sequence[int], kp_: int = 32
               ) -> Dict[str, List[int]]:
    """p_off (offset of each layer's (W, b) in the packed parameters),
    n_params, the packs' offsets and size (k extents a multiple of kp_;
    the streamed form, ops/stream.py, reads p_off and n_params only)."""
    p_off, n = [], 0
    for fin, fout in zip(widths[:-1], widths[1:]):
        p_off.append(n)
        n += fin * fout + fout
    wf, wb, total = packed_layout(widths, kp_)
    return {"p_off": p_off, "n_params": n, "wf_off": wf, "wb_off": wb,
            "wp_total": total}


def dw_columns(fout: int) -> int:
    """Columns of a layer's dW block (DwGeom::kO): 64 (8 warps) for layers
    of at most 64 outputs, else 128 (16 warps)."""
    return 64 if fout <= 64 else OB_O


def dw_tiles(fin: int, fout: int) -> Tuple[int, int]:
    """(i-blocks, o-blocks) of a layer's fin x fout gradient of W (db is
    summed by the first i-block's blocks)."""
    return -(-fin // OB_I), -(-fout // dw_columns(fout))
