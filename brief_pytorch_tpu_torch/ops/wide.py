"""The Python side of csrc/wide.cuh: the layer products of the train
kernel's wide layout (ops/fused_train.py), for chains whose weights do
not fit in shared memory.

A block takes a tile of T coordinates (one of TILES) with 4 T threads and
holds two buffers of activation rows (rows_max(widths) rows of T floats)
and two weight slabs of SLAB floats; the weights stay in device memory in
a packed copy, each layer's W with its bias as row fin, zero-padded to
(round64(fin + 1), round64(fout)) (packed_layout).  Chains whose rows do
not fit take the streamed form (ops/stream.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

OB = 64                  # wide::kOB: outputs per product block
KS = 32                  # wide::kKS: slab depth
SLAB = OB * (KS + 4)     # wide::kSlab: floats per slab buffer
TILES = (64, 32, 16, 8)  # coordinates per tile: the kernels' instances


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def rows_max(widths: Sequence[int]) -> int:
    """Rows of one activation buffer: every layer's input with its ones
    row, zero-padded to the slab depth."""
    return max(round_up(w + 1, KS) for w in widths)


def packed_layout(widths: Sequence[int]) -> Tuple[List[int], List[int]]:
    """(wp_off, colpad): float offset of each layer's packed W in the
    packed copy (wp_off[-1]: its size) and its row stride."""
    wp_off, colpad = [0], []
    for fin, fout in zip(widths[:-1], widths[1:]):
        colpad.append(round_up(fout, OB))
        wp_off.append(wp_off[-1] + round_up(fin + 1, OB) * colpad[-1])
    return wp_off, colpad


def choose_tile(smem_bytes: Callable[[int], int], smem_limit: int,
                sm_smem: int) -> Optional[int]:
    """The tile that keeps the most coordinates resident per SM (ties to
    the larger tile), among those whose block fits `smem_limit`; None
    when none does."""
    best, best_resident = None, 0
    for tile in TILES:
        b = smem_bytes(tile)
        if b > smem_limit:
            continue
        resident = tile * min(2048 // (4 * tile), sm_smem // (b + 1024))
        if resident > best_resident:
            best, best_resident = tile, resident
    return best


def layer_meta(widths: Sequence[int]) -> Dict[str, List[int]]:
    """p_off (offset of each layer's (W, b) in the packed parameters),
    wp_off and colpad."""
    p_off, n = [], 0
    for fin, fout in zip(widths[:-1], widths[1:]):
        p_off.append(n)
        n += fin * fout + fout
    wp_off, colpad = packed_layout(widths)
    return {"p_off": p_off, "n_params": n, "wp_off": wp_off,
            "colpad": colpad}
