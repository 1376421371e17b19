"""The Python side of csrc/chain_stream.cuh: kernels 2 and 3's streamed
form, for every plain chain with a layer (or an input) wider than 256
features, STREAM_WIDTH (the grid decode, ops/fused_decode.py, and the
batch-major forward, ops/fused_siren.py, send them here; 256 is the
widest layer the wide form holds in shared memory).

The plan (`stream_plan`) sorts a chain's layers into thin ones (layer 0
when c_in + 1 <= 8, the last when c_out <= 8, in chains of two or more
layers: computed as reductions on the CUDA cores, layer 0 from the
coordinates wherever it is read) and square ones (products on the tensor
cores in 3xTF32, tiles of 128 rows and 128 columns, or 64 where that pads
a layer's outputs less), and lays out the device scratch: the square
layers' W copies zero-padded to whole tiles, two buffers H of the layer
inputs (rows of R floats, R rows a chunk), and the partial sums of a thin
last layer.  `stream_call` sizes a call of N rows (its chunks, the
splits of a 3-F-1 chain's feature blocks, its kernels), `scratch_bytes`
its scratch, `stream_table` is the kernels' per-layer table,
`stream_model` their arithmetic on the CPU.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from brief_pytorch_tpu_torch.ops.chain import (ACTS, LayerSpec, f32_word,
                                               i64_words, pad_row)
from brief_pytorch_tpu_torch.ops.tc_model import (GROUP_K, act, fma,
                                                  mma_tf32_model,
                                                  tf32_split_nearest,
                                                  z_from_x)

STREAM_WIDTH = 256       # a layer wider than this: the streamed form
GM = GN = 128            # kGM, kGN: a square product's tile
GN64 = 64                # kGN64: the narrow tile's columns
GK = 32                  # kGK: slab depth
WN, MT, NT = 4, 4, 4     # kWN warps along n, a warp's kMT x kNT mma tiles
GEMM_SMEM = 4 * (3 * 2 * GK * (GM + 8) + 4 * MT * NT * 256)   # kGemmSmem
FB = 256                 # kFB: features a block of the thin sums
THIN_ROWS = 1024         # kThinRows: rows a block of the thin kernel
X_MAX = 8                # kXMax: c_in + 1 a thin layer 0 may have
CO_MAX = 8               # kCOMax: c_out a thin last layer may have
ROW_WORDS = 12           # sizeof(StreamLayer) / 4
THIN_SMEM = 4 * FB * (X_MAX + CO_MAX)
H_BUDGET = 1 << 28       # bytes of the two H buffers of a chunk, at most
THIN_CHUNK = 1 << 22     # rows a chunk of a 3-F-1 chain, at most
THIN_PER_SM = 16         # thin kernel blocks aimed at a chunk, an SM
H100_SMS = 132           # SMs of an H100: the CPU model's card


def _r(x: int, m: int) -> int:
    return -(-x // m) * m


def takes(widths: Sequence[int]) -> bool:
    """Whether a chain takes the streamed form: a layer (or the input)
    wider than STREAM_WIDTH features, more than the wide form's shared
    memory holds (ops/fused_decode.py wide_plan)."""
    return max(int(w) for w in widths) > STREAM_WIDTH


def stream_plan(widths: Sequence[int]) -> Dict:
    """The streamed form's layout for a chain of `widths` (any widths, so
    that tests can force it at small ones): which ends are thin (t0, tl),
    the square layers, whether the chain is a thin 3-F-1 (`thin`), the
    rows of an H buffer (round128 of the widest square input, h_rows;
    `n_h` buffers), each square layer's product tiles' columns (gn: GN64
    where round64(fout) < round128(fout), else GN), the padded W copies (wp_off, wp_cols = round_gn(fout), round32(fin) rows;
    wp_total floats).  Its layout is "wide" with "stream" set, as kernel
    1's streamed form (ops/stream.py) states it."""
    widths = [int(w) for w in widths]
    L = len(widths) - 1
    c_in, c_out = widths[0], widths[-1]
    t0 = L >= 2 and c_in + 1 <= X_MAX
    tl = L >= 2 and c_out <= CO_MAX
    square = [l for l in range(L)
              if not (l == 0 and t0) and not (l == L - 1 and tl)]
    wp_off, wp_cols, gn, off = [-1] * L, [0] * L, [0] * L, 0
    for l in square:
        fout = widths[l + 1]
        gn[l] = GN64 if _r(fout, GN64) < _r(fout, GN) else GN
        wp_off[l], wp_cols[l] = off, _r(fout, gn[l])
        off += _r(widths[l], GK) * wp_cols[l]
    if off >= 1 << 31:
        raise ValueError(f"chain widths {widths}: its padded weights "
                         f"({4 * off:,} bytes) pass the kernel's 32-bit "
                         f"offsets")
    return {"layout": "wide", "stream": True, "inst": None, "tile": GM,
            "blocks_per_sm": 1, "warps_per_sm": 8, "c_in": c_in,
            "c_out": c_out, "t0": t0, "tl": tl, "square": square,
            "thin": not square,
            "h_rows": max((_r(widths[l], GM) for l in square), default=0),
            "n_h": min(2, len(square)), "wp_off": wp_off,
            "wp_cols": wp_cols, "gn": gn, "wp_total": off,
            "work": [widths[l] * widths[l + 1] for l in range(L)],
            "n_fb": -(-widths[1] // FB) if not square else 0,
            "smem_bytes": GEMM_SMEM if square else THIN_SMEM}


def stream_call(p: Dict, n: int, sms: int = H100_SMS) -> Dict:
    """A call of n rows on a card of `sms` SMs (the device's
    multi_processor_count; the CPU model takes an H100's): R rows a chunk
    (a multiple of 128: the H buffers within H_BUDGET; a 3-F-1 chain's at
    most THIN_CHUNK), `chunks`, S splits of the thin sums' feature blocks
    (as many as bring a chunk to THIN_PER_SM blocks an SM), `tiles`
    partial sums a row before a thin last
    layer, the floats of one H buffer (h_floats) and of the partial sums
    (part_floats), and the kernels the call launches."""
    n = int(n)
    if p["thin"]:
        R = min(_r(n, THIN_ROWS), THIN_CHUNK)
        S = max(1, min(p["n_fb"],
                       -(-THIN_PER_SM * sms // -(-R // THIN_ROWS))))
        tiles = S
    else:
        # a whole number of waves of product blocks (one an SM) a chunk
        # where the budget holds one: its largest product's column tiles
        # times the chunk's row tiles a multiple of sms
        big = max(p["square"], key=lambda l: p["work"][l])
        quantum = GM * sms // math.gcd(sms, p["wp_cols"][big] // p["gn"][big])
        cap = H_BUDGET // (4 * p["n_h"] * p["h_rows"])
        R = min(_r(n, GM), cap // quantum * quantum or max(GM, cap // GM * GM))
        S = 1
        L = len(p["wp_cols"])
        tiles = p["wp_cols"][L - 2] // p["gn"][L - 2] if p["tl"] else 0
    chunks = -(-n // R)
    per_chunk = 2 if p["thin"] else \
        1 + len(p["square"]) + int(p["tl"])
    return {"R": R, "S": S, "chunks": chunks, "tiles": tiles,
            "h_floats": p["h_rows"] * R,
            "part_floats": tiles * R * p["c_out"],
            "kernels": chunks * per_chunk + (0 if p["thin"] else 1)}


def scratch_bytes(p: Dict, call: Dict) -> int:
    """Device bytes one call holds besides its output: the padded W
    copies, the H buffers and the partial sums."""
    return 4 * (p["wp_total"] + p["n_h"] * call["h_floats"]
                + call["part_floats"])


def pack_blocks(p: Dict, widths: Sequence[int]) -> int:
    """Blocks a layer of chain_stream_pack_kernel: 256 threads, enough for
    the largest padded W copy, at most 1024."""
    most = max((_r(widths[l], GK) * p["wp_cols"][l] for l in p["square"]),
               default=0)
    return max(1, min(1024, -(-most // 256)))


def buffers(p: Dict, call: Dict, device) -> Dict[str, Optional[torch.Tensor]]:
    """The call's scratch on `device` (scratch_bytes of it): the padded W
    copies, the two H buffers, the partial sums; None where one is
    empty."""
    sizes = {"wp": p["wp_total"], "h": p["n_h"] * call["h_floats"],
             "part": call["part_floats"]}
    return {k: torch.empty(v, dtype=torch.float32, device=device) if v
            else None for k, v in sizes.items()}


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
                 ptrs: Sequence[int]) -> List[int]:
    """The streamed form's table (csrc/chain_stream.cuh StreamLayer rows):
    per layer its W and b pointers (ptrs, 2 a layer), widths, activation,
    w0, its padded W copy's offset and row stride, its product tiles'
    columns."""
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            i64_words(ptrs[2 * l]) + i64_words(ptrs[2 * l + 1]) +
            [int(widths[l]), int(widths[l + 1]), ACTS.index(act),
             f32_word(w0), p["wp_off"][l], p["wp_cols"][l], p["gn"][l]],
            ROW_WORDS)
    return words


# --------------------------------------------------------------------------
# the kernels' arithmetic on the CPU
# --------------------------------------------------------------------------
def _h1(x: torch.Tensor, layer, act_w0) -> torch.Tensor:
    """h_1 (n, F) of a thin layer 0 as z_from_x computes it (kernel 1's
    streamed form computes it alike, tc_model.z_from_x): the bias,
    then one fmaf a coordinate, then the activation."""
    z = z_from_x(x.T[None], layer["w"].float().cpu()[None],
                 layer["b"].float().cpu()[None])[0].T
    return act(z, *act_w0)


def _square(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (n, K) @ w (K, N) as chain_stream_gemm_kernel sums it: per k-block
    of 8 the three 3xTF32 products a_small b_big, a_big b_small, a_big
    b_big (both operands split to nearest) through mma_tf32_model from
    zero, added in float32 to the group's sum; every GROUP_K k-blocks the
    group is added to the running total and starts again from zero."""
    n, K = h.shape
    fout, kb = w.shape[1], -(-K // 8)
    hp, wp = torch.zeros(n, 8 * kb), torch.zeros(8 * kb, fout)
    hp[:, :K], wp[:K] = h, w
    ab, as_ = tf32_split_nearest(hp.view(n, kb, 8).transpose(0, 1)
                                 .contiguous())
    bb, bs = tf32_split_nearest(wp.view(kb, 8, fout))
    step = max(1, (1 << 22) // (n * 9 * fout))    # k-blocks a batch
    tot, grp, done = torch.zeros(n, fout), torch.zeros(n, fout), 0
    for k0 in range(0, kb, step):
        k = slice(k0, k0 + step)
        sums = mma_tf32_model(torch.zeros(ab[k].shape[0], n, fout), as_[k],
                              bb[k])
        sums = mma_tf32_model(sums, ab[k], bs[k])
        for sk in mma_tf32_model(sums, ab[k], bb[k]):
            if done and done % GROUP_K == 0:
                tot, grp = tot + grp, torch.zeros(n, fout)
            grp, done = grp + sk, done + 1
    return tot + grp


def stream_model(layers, coords: torch.Tensor, acts: LayerSpec,
                 plan: Dict, sms: int = H100_SMS) -> torch.Tensor:
    """The streamed form's outputs (n, c_out) as csrc/chain_stream.cuh
    computes them on an H100, on the CPU, for the chain in `plan`
    (stream_plan, which may force the form at small widths):
    thin 3-F-1: per block of FB features the fmaf sum of h_1 W_1 from zero
    in feature order, the blocks added in order to their split's sum, the
    splits (stream_call) added in order after the bias; square layers: the
    3xTF32 k-block sums in groups of 32 (`_square`, the card's mma.sync
    sums through tc_model.mma_tf32_model), then the bias and the
    activation; before a thin last layer the sums over
    each tile of gn features (128 or 64) in the order of the kernel's
    epilogue (a thread's gn / 16 features of the tile by fmaf, its 4
    lanes, the 4 warps), the tiles added in order after the bias."""
    x = coords.float().cpu()
    n = x.shape[0]
    L = len(layers)
    w = [l["w"].float().cpu() for l in layers]
    b = [l["b"].float().cpu() for l in layers]
    call = stream_call(plan, n, sms)
    if plan["thin"]:
        h = _h1(x, layers[0], acts[0])
        F, per = h.shape[1], -(-plan["n_fb"] // call["S"])
        z = b[1].expand(n, -1)
        for s in range(call["S"]):
            tot = torch.zeros(n, w[1].shape[1])
            for f0 in range(s * per * FB, min(F, (s + 1) * per * FB), FB):
                blk = torch.zeros_like(tot)
                for o in range(f0, min(F, f0 + FB)):
                    blk = fma(h[:, o:o + 1], w[1][o][None], blk)
                tot = tot + blk
            z = z + tot
        return act(z, *acts[1])
    h = _h1(x, layers[0], acts[0]) if plan["t0"] else x
    for l in plan["square"]:
        z = _square(h, w[l]) + b[l]
        h = act(z, *acts[l])
        if l == L - 1:
            return h
    # the thin last layer: per tile of gn features, per warp wn and lane
    # q the fmaf sum of its 2 nt features (column 8 nt wn + 8 j + 2 q + p,
    # j then p), the lanes (q0 + q1) + (q2 + q3), the warps in order
    F, gn = h.shape[1], plan["gn"][L - 2]
    nt = gn // (8 * WN)
    hp = torch.zeros(n, _r(F, gn))
    hp[:, :F] = h
    wl = torch.zeros(_r(F, gn), w[-1].shape[1])
    wl[:F] = w[-1]
    z = b[-1].expand(n, -1)
    for t0 in range(0, hp.shape[1], gn):
        warps = []
        for wn in range(WN):
            lanes = []
            for q in range(4):
                s = torch.zeros(n, wl.shape[1])
                for j in range(nt):
                    for p_ in range(2):
                        o = t0 + 8 * nt * wn + 8 * j + 2 * q + p_
                        s = fma(hp[:, o:o + 1], wl[o][None], s)
                lanes.append(s)
            warps.append((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
        tile = warps[0]
        for x_ in warps[1:]:
            tile = tile + x_
        z = z + tile
    return act(z, *acts[-1])

