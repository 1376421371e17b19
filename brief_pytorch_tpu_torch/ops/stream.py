"""The Python side of csrc/fused_train_stream.cu: kernel 1's streamed
form, for chains with a layer wider than the wide layout takes
(fused_train.WIDE_MAX_FEATURES; ops/fused_train.py choose_plan sends
them here).

The plan (`stream_plan`) sorts a chain's layers into thin ones (layer 0
when c_in + 1 <= 8, the last when c_out <= 8: reductions on the CUDA
cores, their input recomputed where it is read) and square ones (products
on the tensor cores, 3xTF32, 128 x 128 tiles), and lays out the device
scratch: per stored hidden layer one row set of its pre-activation z
(overwritten by its g in the backward), the operand row set H, the loss's
g_L and the thin last layer's partial sums, each row np = round256(N)
floats.  `stream_splits` cuts each layer's gradient sums over the
coordinates into splits; `stream_table` is the kernel's per-layer table;
`stream_emulation` is the kernel's arithmetic on the CPU; `launch` runs
the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from brief_pytorch_tpu_torch.ops import wide
from brief_pytorch_tpu_torch.ops.chain import (ACTS, LayerSpec, f32_word,
                                               layer_table, pad_row)
from brief_pytorch_tpu_torch.ops.tc_model import fma, z_from_x

GM = GN = 128            # kGM, kGN: a product's tile
GK = 32                  # kGK: slab depth
STAGES = 3               # kGStages
GROUP_K = 32             # kGroupK: k-blocks a group of the product sums
FB = 256                 # kFB: features a block of the thin kernels
CHUNK = 32               # kChunk: coordinates a chunk of the thin sums
X_MAX = 8                # kXMax: c_in + 1 a thin layer 0 may have
CO_MAX = 8               # c_out a thin last layer may have
NP_ALIGN = 256           # np: N rounded up to this
STREAM_ROW_WORDS = 16    # sizeof(StreamLayer) / 4
GEMM_SMEM = 4 * (STAGES * 2 * GN * (GK + 4) + 64 * 256)   # kGemmSmem
THIN_SMEM = 4 * (FB * (CHUNK + 1) + (CO_MAX + X_MAX) * CHUNK)
THIN_BLOCKS = 8448       # thin sums' blocks aimed at a call: 64 per H100 SM
GEMM_BLOCKS = 264        # dW tiles aimed at a call: 2 per SM

launches = 0             # calls of the streamed form, for proof that a run used it

_SIGNATURES = {
    "brief_fused_train_stream": [ctypes.c_void_p] * 13 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
}


def _r(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_plan(widths: Sequence[int]) -> Dict:
    """The streamed form's layout for a chain of `widths` (at least two
    layers): which ends are thin (t0, tl), the square layers, and the
    scratch rows of one chain (np floats each): out_row[l], where z_{l+1}
    and later g_{l+1} live (round128(f) rows a square layer's output; the
    thin last layer's, its c_out rows of g_L; -1 for a thin layer 0),
    h_row (H, round128 of the widest square input), pp_row (n_pp blocks
    of c_out partial rows of the thin forward); the padded W copies
    (wp_off, wp_cols = round128(fout), round128(fin) rows)."""
    L = len(widths) - 1
    if L < 2:
        raise ValueError(f"the streamed form takes chains of two or more "
                         f"layers, not {list(widths)}")
    c_in, c_out = widths[0], widths[-1]
    t0, tl = c_in + 1 <= X_MAX, c_out <= CO_MAX
    square = [l for l in range(L)
              if not (l == 0 and t0) and not (l == L - 1 and tl)]
    out_row, row = [-1] * L, 0
    for l in square:           # every hidden layer but a thin layer 0's
        out_row[l] = row
        row += _r(widths[l + 1], GN)
    h_row = row if square else -1
    row += max((_r(widths[l], GM) for l in square), default=0)
    n_pp = -(-widths[L - 1] // FB) if tl else 0
    pp_row = -1
    if tl:
        out_row[L - 1] = row
        row += c_out
        pp_row = row
        row += n_pp * c_out
    wp_off, wp_cols, off = [-1] * L, [0] * L, 0
    for l in square:
        wp_off[l], wp_cols[l] = off, _r(widths[l + 1], GN)
        off += _r(widths[l], GM) * wp_cols[l]
    meta = wide.layer_meta(widths)
    return {"layout": "wide", "stream": True, "t0": t0, "tl": tl,
            "square": square, "out_row": out_row, "h_row": h_row,
            "pp_row": pp_row, "n_pp": n_pp, "rows_total": row,
            "wp_off": wp_off, "wp_cols": wp_cols, "wp_total": off,
            "p_off": meta["p_off"], "n_params": meta["n_params"],
            "block": FB, "threads": FB,
            "smem_bytes": GEMM_SMEM if square else THIN_SMEM}


def _thin_rows(p: Dict, widths: Sequence[int], l: int) -> int:
    """Rows (feature blocks of FB) a thin layer's sums run over: the last
    layer's F + 1 (its bias row), layer 0's F_1 (the last layer's when both
    are summed by one launch)."""
    L = len(widths) - 1
    if l == L - 1 or (L == 2 and p["tl"]):
        return widths[L - 1] + 1
    return widths[1]


def _cut(np_: int, want: int) -> Tuple[int, int]:
    """(splits, chunk): [0, np_) in about `want` splits of a multiple of
    CHUNK coordinates, at least 256 each."""
    splits = max(1, min(want, np_ // 256))
    chunk = _r(-(-np_ // splits), CHUNK)
    return -(-np_ // chunk), chunk


def stream_splits(p: Dict, widths: Sequence[int], n: int,
                  n_fleet: int) -> Dict:
    """The call's shape at n coordinates for n_fleet chains: np, and per
    layer the regions of the partial sums of its W (part_off, splits of
    the coordinates, chunk coordinates a split, a multiple of 32; fin *
    fout floats a split) and of its b (bpart_off, bsplits, bchunk; fout
    floats a split), part_total floats a chain, the loss kernel's blocks.
    A square layer's dW aims at GEMM_BLOCKS tiles in all, its db and a
    thin layer's sums (W and b in one launch, so one cut) at THIN_BLOCKS
    blocks."""
    L = len(widths) - 1
    np_ = _r(n, NP_ALIGN)
    thin = lambda rows: -(-THIN_BLOCKS // (n_fleet * -(-rows // FB)))
    layers = []
    off = 0
    for l in range(L):
        fin, fout = widths[l], widths[l + 1]
        if l in p["square"]:
            splits, chunk = _cut(np_, -(-GEMM_BLOCKS // (
                n_fleet * -(-fin // GM) * -(-fout // GN))))
            bsplits, bchunk = _cut(np_, thin(fout))
        else:
            splits, chunk = _cut(np_, thin(_thin_rows(p, widths, l)))
            bsplits, bchunk = splits, chunk
        layers.append({"part_off": off, "splits": splits, "chunk": chunk,
                       "bpart_off": off + splits * fin * fout,
                       "bsplits": bsplits, "bchunk": bchunk})
        off += splits * fin * fout + bsplits * fout
    return {"np": np_, "layers": layers, "part_total": off,
            "loss_blocks": np_ // 256}


def scratch_bytes(p: Dict, sp: Dict, n_fleet: int) -> int:
    """Device bytes one call holds: the scratch rows, the padded W copies,
    the partial sums and the loss partials (float64)."""
    return n_fleet * (4 * (p["rows_total"] * sp["np"] + p["wp_total"]
                           + sp["part_total"]) + 8 * sp["loss_blocks"])


def stream_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
                 mask_off: Sequence[int], sp: Dict) -> List[int]:
    """The streamed form's table (csrc/fused_train_stream.cu StreamLayer
    rows)."""
    words = []
    for l, (act, w0) in enumerate(acts):
        s = sp["layers"][l]
        words += pad_row(
            [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
             p["wp_off"][l], p["wp_cols"][l], p["out_row"][l], mask_off[l],
             s["part_off"], s["splits"], s["chunk"], s["bpart_off"],
             f32_word(w0), s["bsplits"], s["bchunk"]], STREAM_ROW_WORDS)
    return words


# --------------------------------------------------------------------------
# the kernel's arithmetic on the CPU
# --------------------------------------------------------------------------
def _act(z, act: str, w0: float, mask):
    from brief_pytorch_tpu_torch.ops.fused_train import _act_fwd
    h, d = _act_fwd(z, act, w0)
    if d is None:
        d = torch.ones_like(z)
    if mask is not None:
        m = mask[:, :, None].float()
        h, d = h * m, d * m
    return h, d


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, N) = a (B, M, K) b (B, K, N) as stream_gemm_kernel sums it:
    3xTF32 per k-block of 8 (fused_train._kblock_sums), the k-blocks
    added in float32 in groups of GROUP_K from zero, the groups added to
    the running sum in order."""
    from brief_pytorch_tpu_torch.ops.fused_train import (_kblock_sums,
                                                         _sum_in_order)
    if a.shape[-1] == 0:          # a split past the coordinates
        return torch.zeros(a.shape[0], a.shape[1], b.shape[-1])
    d = _kblock_sums(a, b)                        # (B, KB, M, N)
    groups = [_sum_in_order(d[:, k:k + GROUP_K], 1)
              for k in range(0, d.shape[1], GROUP_K)]
    return _sum_in_order(torch.stack(groups, 1), 1)


def _split_sums(terms, n: int, cut: Tuple[int, int],
                chunked: bool) -> torch.Tensor:
    """Sum over the coordinates [0, n) of terms(lo, hi) per split of `cut`
    (splits, chunk), then the splits in order in float64: each split's
    chunks of CHUNK coordinates from zero, added to the split's running
    sum (chunked), or terms(lo, hi) already a split's sum (not
    chunked)."""
    parts = []
    for s in range(cut[0]):
        lo = s * cut[1]
        hi = min(n, lo + cut[1])
        if not chunked:
            parts.append(terms(lo, max(lo, hi)))
            continue
        acc = None
        for u0 in range(lo, hi, CHUNK):
            cs = terms(u0, min(hi, u0 + CHUNK))
            acc = cs if acc is None else acc + cs
        parts.append(acc)
    total = None
    for x in parts:
        if x is not None:
            total = x.double() if total is None else total + x.double()
    return total


def _w(sp: Dict, l: int) -> Tuple[int, int]:
    return sp["layers"][l]["splits"], sp["layers"][l]["chunk"]


def _b(sp: Dict, l: int) -> Tuple[int, int]:
    return sp["layers"][l]["bsplits"], sp["layers"][l]["bchunk"]


def _seq_fma_sum(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_u fmaf(h[..., u], g[..., u], acc) from zero, u in order."""
    acc = torch.zeros(torch.broadcast_shapes(h.shape, g.shape)[:-1])
    for u in range(h.shape[-1]):
        acc = fma(h[..., u], g[..., u], acc)
    return acc


def stream_emulation(layers, coords, values, weights, acts: LayerSpec, *,
                     loss_name: str, beta: float = 0.01, thres=None,
                     unit_masks=None, plan: Optional[Dict] = None):
    """The streamed form's arithmetic (csrc/fused_train_stream.cu) on the
    CPU for a fleet shaped as fused_train_grads_fleet takes it (thres:
    None or (B,), -inf for none), in the plan `plan` (stream_plan of the
    chain unless given, so a narrow chain can be forced through it).

    Thin layer 0: z_1 = b + sum_c x_c W[c] by fmaf.  Thin last layer: z_L
    = b, then per block of FB features the fmaf sum of h W in feature
    order; its dW and g_{L-1} = d (fmaf sum of W g_L) per feature, its sums
    over the coordinates in chunks of CHUNK from zero, per split.  Square
    layers: every product in 3xTF32 on k-blocks of 8, groups of GROUP_K
    k-blocks (`_product`), dW per split of the coordinates, db by chunks;
    the splits added in order and divided by N * Cout.  The loss: per
    coordinate in float32, then in float64: in blocks of 256 by a halving
    tree, the blocks in order."""
    nb, c_in, n = coords.shape
    widths = [c_in] + [int(l["w"].shape[-1]) for l in layers]
    L = len(widths) - 1
    p = plan or stream_plan(widths)
    sp = stream_splits(p, widths, n, nb)
    masks = list(unit_masks) if unit_masks is not None else [None] * L
    masks += [None] * (L - len(masks))
    x = coords.float()
    c_out = widths[-1]
    zs = [None] * (L + 1)          # z_l (B, f_l, N) as the kernel holds it

    def h_d(l):                    # h_l, d_l from z_l (l >= 1) or x (l = 0)
        if l == 0:
            return x, None
        if zs[l] is None:          # z_1 of a thin layer 0: recomputed
            zs[l] = z_from_x(x, layers[0]["w"], layers[0]["b"])
        act, w0 = acts[l - 1]
        return _act(zs[l], act, w0, masks[l - 1])

    for l in range(L):
        if l == 0 and p["t0"]:
            continue
        if l == L - 1 and p["tl"]:
            h, _ = h_d(l)
            w = layers[l]["w"].float()
            z = layers[l]["b"][:, :, None].expand(-1, -1, n).float()
            for f0 in range(0, widths[l], FB):
                acc = torch.zeros(nb, c_out, n)
                for o in range(f0, min(widths[l], f0 + FB)):
                    acc = fma(h[:, o:o + 1, :], w[:, o, :, None], acc)
                z = z + acc
            zs[L] = z
            continue
        h, _ = h_d(l)
        zs[l + 1] = _product(h.transpose(1, 2), layers[l]["w"].float()
                             ).transpose(1, 2) + layers[l]["b"][:, :, None]
    act, w0 = acts[L - 1]
    pred, dv = _act(zs[L], act, w0, masks[L - 1])
    weff = weights if thres is None else torch.where(
        pred <= thres[:, None, None], 1.0, weights)
    e = pred - values
    if loss_name == "datal2":
        l_elem, g = e * e, 2.0 * weff * e
    else:
        ae = e.abs()
        l_elem = torch.where(ae < beta, 0.5 * ae * ae / beta, ae - 0.5 * beta)
        g = weff * torch.where(ae < beta, e / beta, torch.sign(e))
    g = g * dv
    lossc = torch.zeros(nb, n)
    for c in range(c_out):
        lossc = lossc + weff[:, c] * l_elem[:, c]
    lossc = torch.nn.functional.pad(lossc.double(), (0, sp["np"] - n)
                                    ).view(nb, -1, 256)
    s = 128
    while s:
        lossc = lossc[..., :s] + lossc[..., s:2 * s]
        s //= 2
    loss = lossc[..., 0][:, 0]
    for k in range(1, lossc.shape[1]):
        loss = loss + lossc[:, k, 0]
    m = float(n * c_out)
    loss = loss / m
    grads = [None] * L
    gs = [None] * (L + 1)
    gs[L] = g

    def put(l, dw):
        dw = (dw.double() / m).float()
        grads[l] = {"w": dw[:, :-1], "b": dw[:, -1]}

    if p["tl"]:
        l = L - 1
        F = widths[l]
        h, d = h_d(l)
        w = layers[l]["w"].float()
        gsum = torch.zeros(nb, F, n)
        for c in range(c_out):
            gsum = fma(w[:, :, c, None], g[:, c:c + 1, :], gsum)
        g_in = d * gsum
        hb = torch.cat([h, torch.ones(nb, 1, n)], 1)       # the bias row
        dw = _split_sums(lambda lo, hi: torch.stack(
            [_seq_fma_sum(hb[:, :, lo:hi], g[:, c:c + 1, lo:hi])
             for c in range(c_out)], -1), n, _w(sp, l), True)
        put(l, dw)
        gs[l] = g_in
        if L == 2 and p["t0"]:
            xb = torch.cat([x, torch.ones(nb, 1, n)], 1)
            dw0 = _split_sums(lambda lo, hi: torch.stack(
                [_seq_fma_sum(g_in[:, :, lo:hi], xb[:, c:c + 1, lo:hi])
                 if c < c_in else _seq_sum(g_in[:, :, lo:hi])
                 for c in range(c_in + 1)], 1), n, _w(sp, 0), True)
            put(0, dw0)
    for l in range(L - 1, -1, -1):
        if l == L - 1 and p["tl"]:
            continue
        if l == 0 and p["t0"]:
            if grads[0] is None:
                xb = torch.cat([x, torch.ones(nb, 1, n)], 1)
                g1 = gs[1]
                dw0 = _split_sums(lambda lo, hi: torch.stack(
                    [_seq_fma_sum(g1[:, :, lo:hi], xb[:, c:c + 1, lo:hi])
                     if c < c_in else _seq_sum(g1[:, :, lo:hi])
                     for c in range(c_in + 1)], 1), n, _w(sp, 0), True)
                put(0, dw0)
            continue
        h, _ = h_d(l)
        gn = gs[l + 1]
        dw = _split_sums(lambda lo, hi: _product(h[:, :, lo:hi],
                                                 gn[:, :, lo:hi].transpose(1, 2)),
                         n, _w(sp, l), False)
        db = _split_sums(lambda lo, hi: _seq_sum(gn[:, :, lo:hi]), n,
                         _b(sp, l), True)
        put(l, torch.cat([dw, db[:, None, :]], 1))
        if l > 0:
            _, d = h_d(l)
            gs[l] = _product(gn.transpose(1, 2),
                             layers[l]["w"].float().transpose(1, 2)
                             ).transpose(1, 2) * d
    return loss.float(), {"layers": grads}


def _seq_sum(g: torch.Tensor) -> torch.Tensor:
    """sum over the last axis in order, float32, from zero."""
    acc = torch.zeros(g.shape[:-1])
    for u in range(g.shape[-1]):
        acc = acc + g[..., u]
    return acc


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
_BUFFERS: Dict[torch.device, Tuple[tuple, Dict[str, torch.Tensor]]] = {}


def _buffers(device: torch.device, p: Dict, sp: Dict, n_fleet: int
             ) -> Dict[str, torch.Tensor]:
    """The call's device scratch (scratch_bytes), kept for the last shape
    per device and reused by every call of that shape (a training run's
    steps); a new shape frees it first.  Where the card cannot hold it,
    torch.cuda.OutOfMemoryError names its bytes."""
    key = (p["rows_total"], p["wp_total"], sp["np"], sp["part_total"],
           n_fleet)
    if device not in _BUFFERS or _BUFFERS[device][0] != key:
        _BUFFERS.pop(device, None)
        shapes = {"scratch": (n_fleet, p["rows_total"], sp["np"]),
                  "wp": (n_fleet, max(1, p["wp_total"])),
                  "partial": (n_fleet, sp["part_total"]),
                  "lossp": (n_fleet, sp["loss_blocks"])}
        try:
            bufs = {k: torch.empty(v, device=device, dtype=torch.float64
                                   if k == "lossp" else torch.float32)
                    for k, v in shapes.items()}
        except torch.cuda.OutOfMemoryError as e:
            raise torch.cuda.OutOfMemoryError(
                f"the train kernel's streamed form needs "
                f"{scratch_bytes(p, sp, n_fleet):,} bytes of device scratch "
                f"for {n_fleet} chain(s) at N = {sp['np']:,}; {device} "
                f"cannot hold it: fewer coordinates a step "
                f"(Compress.sampler.sample_size) shrink it") from e
        _BUFFERS[device] = (key, bufs)
    return _BUFFERS[device][1]


def free_buffers() -> None:
    _BUFFERS.clear()


def launch(p: Dict, params: torch.Tensor, coords, values, weights,
           widths: Sequence[int], acts: LayerSpec,
           masks: Optional[torch.Tensor], mask_off: Sequence[int],
           thres: Optional[torch.Tensor], loss: int, beta: float
           ) -> torch.Tensor:
    """One call of the streamed form for n_fleet = coords.shape[0] chains:
    (n_fleet, n_params + 1), the gradients in the packed layout and the
    loss, divided by N * Cout.  params (n_fleet, n_params); masks
    (n_fleet, mask_width) or None."""
    from brief_pytorch_tpu_torch.ops import build
    device = coords.device
    n_fleet, n = coords.shape[0], coords.shape[-1]
    sp = stream_splits(p, widths, n, n_fleet)
    key = ("stream", tuple(widths), tuple(acts), tuple(mask_off), sp["np"],
           n_fleet)
    table, head = layer_table(key, lambda: stream_table(
        p, widths, acts, mask_off, sp), device)
    pack = max((_r(widths[l], GM) * p["wp_cols"][l] for l in p["square"]),
               default=0)
    meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
            0 if masks is None else masks.shape[1], sp["np"],
            p["rows_total"], p["h_row"], p["pp_row"], p["n_pp"],
            sp["part_total"], p["wp_total"], int(p["t0"]), int(p["tl"]),
            sp["loss_blocks"], max(1, min(1024, -(-pack // 256)))]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    lib = build.library("fused_train_stream", _SIGNATURES)
    with torch.cuda.device(device):
        bufs = _buffers(device, p, sp, n_fleet)
        out = torch.empty((n_fleet, p["n_params"] + 1), dtype=torch.float32,
                          device=device)
        build.check(lib.brief_fused_train_stream(
            coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
            params.data_ptr(), 0 if masks is None else masks.data_ptr(),
            0 if thres is None else thres.data_ptr(), table.data_ptr(),
            ctypes.addressof(head), bufs["scratch"].data_ptr(),
            bufs["wp"].data_ptr(), bufs["partial"].data_ptr(),
            bufs["lossp"].data_ptr(), out.data_ptr(), n, n_fleet, meta_c,
            loss, float(beta),
            torch.cuda.current_stream(device).cuda_stream),
            "fused_train stream")
    global launches
    launches += 1
    return out
