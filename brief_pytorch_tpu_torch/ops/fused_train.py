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
work (~45 us at 67 TFLOP/s); csrc/fused_train.cu says how its design
answers that.

Three layouts; `choose_plan` takes the first that fits and `kernel_plan`
raises for a chain none holds:
  * narrow (`plan`; 5 x 22, brain64's 3-7x4-1): W, W^T and the gradient
    accumulator in shared memory beside a tile of up to 128 coordinates,
    one thread per coordinate;
  * tiled (`tiled_plan`; the HiP-CT bucket 3-64x6-1, 3-66x6-1, 5 x 95):
    W once, beside a 32-coordinate tile; 256 threads work on register
    micro-tiles of the three products and keep their share of dW
    (`dw_map`) in registers for the whole call, written once;
  * wide (`wide_plan`; the SingleTask default on the 64x512x512 demo
    volumes, 3-191x4-1 and 3-242x4-1, and fleet buckets past the tiled
    layout such as 3-128x6-1): W streamed through shared memory in slabs
    (ops/wide.py, csrc/wide.cuh), h_l and d_l of every coordinate in a
    device-memory scratch, dW a split-K product over it (`dw_split`).
    Any chain of up to MAX_LAYERS layers whose widest layer fits a tile
    of 8 coordinates (3,327 features) trains.
csrc/fused_train.cu says what bounds each.

`fused_train_grads_fleet` launches the kernel for CUDA tensors and calls
the plain version, `fused_train_grads_reference`, for CPU tensors; there
is no fallback from one to the other.  `fused_train_grads` is its one-chain
form (a fleet of one, which the C side runs without the fleet's parts).
Scope: acts sine, relu, sigmoid, none; losses datal2, datasmoothl1;
float32.  Not ported yet (ROADMAP.md): bf16 inputs (`half`, which the
trainers refuse) and chains of more than MAX_LAYERS layers (kernel_plan
raises NotImplementedError).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from brief_pytorch_tpu_torch.ops import wide
from brief_pytorch_tpu_torch.ops.chain import ACTS, LayerSpec, chain_layer_specs
from brief_pytorch_tpu_torch.ops.fast_math import fast_sincos

LOSSES = ("datal2", "datasmoothl1")
SMEM_LIMIT = 232448          # bytes of shared memory one block may use (H100)
SM_SMEM = 233472             # bytes of shared memory of one SM (H100)
BLOCKS = (128, 64, 32)       # coordinates per tile (= threads per block)
TILED_THREADS = 256          # kTiledThreads of csrc/fused_train.cu
TILED_TILE = 32              # kTile: coordinates per tile of the tiled layout
TILED_SLOTS = (4, 6, 8)      # dW tiles per thread: the kernel's instances
MAX_LAYERS = 16              # kMaxLayers of csrc/chain.cuh
DW_CHUNK = 32                # kDwChunk: coordinates per dW operand chunk
DW_BLOCKS = 1056             # dW blocks aimed at per call: 8 per H100 SM

launches = 0                 # kernel launches, for proof that a run used it

_SIGNATURES = {
    "brief_fused_train_occupancy": [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p],
    "brief_fused_train_tiled_occupancy": [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train_tiled": [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "brief_fused_train_wide_occupancy": [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train_wide": [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def plan(widths: Sequence[int], block: int) -> Dict:
    """Shared-memory layout (in floats) of the narrow layout for a chain of
    `widths` = (c_in, f_1, ..., c_out) and `block` coordinates per tile:
    the weights W (fin, round8(fout)) and W^T (fout, round8(fin)) and the
    bias of every layer, the per-block gradient accumulator, a loss
    reduction buffer of one float per thread and the activation rows
    (coordinates, then h_l and d_l of every layer), each row block + 1
    floats long."""
    n_layers = len(widths) - 1
    off = 0
    p_off, sw_off, swt_off, sb_off, h_row, dg_row = [], [], [], [], [], []
    n_params = 0
    for l in range(n_layers):
        fin, fout = widths[l], widths[l + 1]
        p_off.append(n_params)
        n_params += fin * fout + fout
        sw_off.append(off)
        off += fin * _round8(fout)
        swt_off.append(off)
        off += fout * _round8(fin)
        sb_off.append(off)
        off += _round8(fout)
    acc_off = off
    off += _round8(n_params)
    red_off = off
    off += block
    act_off = _round8(off)
    row = widths[0]
    for l in range(n_layers):
        h_row.append(row)
        row += widths[l + 1]
        dg_row.append(row)
        row += widths[l + 1]
    stride = block + 1
    return {"n_params": n_params, "p_off": p_off, "sw_off": sw_off,
            "swt_off": swt_off, "sb_off": sb_off, "h_row": h_row,
            "dg_row": dg_row, "acc_off": acc_off, "red_off": red_off,
            "act_off": act_off, "stride": stride, "block": block,
            "threads": block, "layout": "narrow",
            "smem_bytes": 4 * (act_off + row * stride)}


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
    n_tiles = len(dw_tiles(widths))
    slots = next((s for s in TILED_SLOTS if n_tiles <= s * TILED_THREADS), 0)
    return {"layout": "tiled", "n_params": n_params, "p_off": p_off,
            "w_off": w_off, "x_row": [0] + h_row[:-1], "h_row": h_row,
            "g_row": g_row, "red_off": red_off, "act_off": act_off,
            "block": TILED_TILE, "threads": TILED_THREADS, "slots": slots,
            "smem_bytes": 4 * (act_off + row * TILED_TILE)}


def wide_plan(widths: Sequence[int], tile: int) -> Dict:
    """Layout of the wide layout for a chain of `widths` and `tile`
    coordinates per tile (4 * tile threads).

    Shared memory: two buffers of rows_max rows of `tile` floats, two
    weight slabs, a loss buffer of one float per thread.  Scratch rows
    (each np = round64(N) floats; B * rows_total of them per call): the
    coordinates (x_row[0] = 0), then per layer h_l (h_row; none for the
    last layer) and d_l / g_l (g_row); x_row[l] is the layer's input.
    dW tiles: layer l's (fin + 1) x fout gradient in 64 x 64 tiles
    (i-block, o-block), numbered from tile0[l], o-blocks fastest."""
    n_layers = len(widths) - 1
    meta = wide.layer_meta(widths)
    rows = wide.rows_max(widths)
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
    return {"layout": "wide", "block": tile, "threads": threads,
            "rows_max": rows, "rows_total": row, "x_row": x_row,
            "h_row": h_row, "g_row": g_row, "tile0": tile0[:-1],
            "n_dw_tiles": tile0[-1], "wp_total": meta["wp_off"][-1], **meta,
            "smem_bytes": 4 * (2 * rows * tile + 2 * wide.SLAB + threads)}


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


def choose_plan(widths: Sequence[int]) -> Optional[Dict]:
    """The layout and tile that keep the most coordinates resident per SM
    (an H100 SM has 228 KB of shared memory, 1 KB of it reserved per
    block): the narrow layout (weights, W^T and the gradient accumulator
    in shared memory) when it fits at any tile; else the tiled layout
    (weights once in shared memory, dW in registers) when its weights and
    32-coordinate tile fit and its dW tiles fit TILED_SLOTS; else the wide
    layout; None past MAX_LAYERS layers or when even the wide layout's
    8-coordinate tile does not fit a block's 227 KB."""
    if len(widths) - 1 > MAX_LAYERS:
        return None
    best, best_resident = None, 0
    for block in BLOCKS:
        p = plan(widths, block)
        if p["smem_bytes"] > SMEM_LIMIT:
            continue
        resident = block * min(2048 // p["threads"],
                               SM_SMEM // (p["smem_bytes"] + 1024))
        if resident > best_resident:
            best, best_resident = p, resident
    if best is not None:
        return best
    p = tiled_plan(widths)
    if p["slots"] and p["smem_bytes"] <= SMEM_LIMIT:
        return p
    tile = wide.choose_tile(lambda t: wide_plan(widths, t)["smem_bytes"],
                            SMEM_LIMIT, SM_SMEM)
    return None if tile is None else wide_plan(widths, tile)


def kernel_plan(widths: Sequence[int]) -> Dict:
    """choose_plan, raising NotImplementedError for a chain the kernel
    cannot hold (the JAX kernel takes it: there is no autograd fallback on
    the card)."""
    p = choose_plan(widths)
    if p is None:
        raise NotImplementedError(
            f"chain widths {widths}: more than {MAX_LAYERS} layers, or a "
            f"layer wider than the wide layout's 8-coordinate tile holds; "
            f"such chains on the train kernel are not ported yet "
            f"(ROADMAP.md)")
    return p


def chain_widths(spec) -> List[int]:
    return [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]


def supports_training(model, loss_name: str) -> bool:
    """Whether the fused train-grad kernel runs this φ model + loss: a plain
    activation chain and a kernel loss (the JAX package's gate).  Raises
    NotImplementedError for such a chain that is too wide (kernel_plan)."""
    if loss_name not in LOSSES:
        return False
    spec = getattr(model, "spec", None)
    if spec is None:
        return False
    try:
        chain_layer_specs(spec)
    except ValueError:
        return False
    kernel_plan(chain_widths(spec))
    return True


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
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
    card at once, but no more than there are tiles."""
    key = (device.index or 0, p["layout"], p["threads"], p["smem_bytes"],
           p.get("slots", 0))
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        from brief_pytorch_tpu_torch.ops import build
        if p["layout"] == "tiled":
            err = lib.brief_fused_train_tiled_occupancy(
                p["slots"], p["smem_bytes"], ctypes.addressof(per_sm),
                ctypes.addressof(sms))
        elif p["layout"] == "wide":
            err = lib.brief_fused_train_wide_occupancy(
                p["block"], p["smem_bytes"], ctypes.addressof(per_sm),
                ctypes.addressof(sms))
        else:
            err = lib.brief_fused_train_occupancy(
                p["threads"], p["smem_bytes"], ctypes.addressof(per_sm),
                ctypes.addressof(sms))
        build.check(err, "fused_train occupancy")
        _OCCUPANCY[key] = max(1, per_sm.value) * sms.value
    per_fleet = -(-_OCCUPANCY[key] // n_fleet)
    return max(1, min(per_fleet, -(-n // p["block"])))


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
    shape (a training run's steps); a new shape frees it first."""
    key = (p["wp_total"], p["rows_total"], p["n_params"], n_fleet, np_,
           grid, splits)
    if device not in _WIDE_BUFFERS or _WIDE_BUFFERS[device][0] != key:
        _WIDE_BUFFERS.pop(device, None)
        empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                           device=device)
        _WIDE_BUFFERS[device] = (key, {
            "wp": empty(n_fleet, p["wp_total"]),
            "scratch": empty(n_fleet, p["rows_total"], np_),
            "partial": empty(n_fleet, splits, p["n_params"]),
            "lossp": empty(n_fleet, grid)})
    return _WIDE_BUFFERS[device][1]


_SLOT_MAPS: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _slot_map(widths, slots: int, device: torch.device) -> torch.Tensor:
    """dw_map as an int32 tensor on `device`, made once per chain shape (a
    step's launch then moves nothing from the host)."""
    key = (tuple(widths), device)
    if key not in _SLOT_MAPS:
        _SLOT_MAPS[key] = torch.tensor(dw_map(widths, slots),
                                       dtype=torch.int32, device=device)
    return _SLOT_MAPS[key]


def _launch(params: torch.Tensor, coords, values, weights, widths, acts,
            masks: Optional[torch.Tensor], mask_off: Sequence[int],
            thres: Optional[torch.Tensor], loss_name: str, beta: float
            ) -> torch.Tensor:
    """One launch for n_fleet = params.shape[0] chains; returns
    (n_fleet, n_params + 1): the gradients in the packed layout, then the
    loss, divided by N * Cout."""
    from brief_pytorch_tpu_torch.ops import build

    device = coords.device
    if loss_name not in LOSSES:
        raise NotImplementedError(loss_name)
    if len(acts) != len(widths) - 1:
        raise ValueError("one (act, w0) per layer")
    key = tuple(widths)
    if key not in _PLANS:
        _PLANS[key] = kernel_plan(widths)
    p = _PLANS[key]
    if params.device != device or params.dtype != torch.float32:
        raise ValueError(f"weights: expected float32 on {device}")
    n_fleet, n = params.shape[0], coords.shape[-1]
    mask_width = 0 if masks is None else masks.shape[1]
    if p["layout"] == "wide":
        np_, splits, chunk = dw_split(n, n_fleet, p["n_dw_tiles"])
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                mask_width, p["rows_max"], np_, p["rows_total"],
                p["wp_total"], p["n_dw_tiles"]]
        for l, (act, _) in enumerate(acts):
            meta += [widths[l], widths[l + 1], ACTS.index(act),
                     p["p_off"][l], p["wp_off"][l], p["colpad"][l],
                     p["x_row"][l], p["h_row"][l], p["g_row"][l],
                     mask_off[l], p["tile0"][l]]
    elif p["layout"] == "tiled":
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                p["red_off"], p["act_off"], mask_width, p["slots"]]
        for l, (act, _) in enumerate(acts):
            meta += [widths[l], widths[l + 1], ACTS.index(act),
                     p["p_off"][l], p["w_off"][l], p["x_row"][l],
                     p["h_row"][l], p["g_row"][l], mask_off[l]]
    else:
        meta = [len(widths) - 1, widths[0], widths[-1], p["n_params"],
                p["stride"], p["acc_off"], p["red_off"], p["act_off"],
                mask_width]
        for l, (act, _) in enumerate(acts):
            meta += [widths[l], widths[l + 1], ACTS.index(act),
                     p["p_off"][l], p["sw_off"][l], p["swt_off"][l],
                     p["sb_off"][l], p["h_row"][l], p["dg_row"][l],
                     mask_off[l]]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    w0_c = (ctypes.c_float * len(acts))(*[float(w0) for _, w0 in acts])

    lib = build.library("fused_train", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        grid = _grid(lib, device, p, n, n_fleet)
        width = p["n_params"] + 1
        out = torch.empty((n_fleet, width), dtype=torch.float32,
                          device=device)
        if p["layout"] == "wide":
            bufs = _wide_buffers(device, p, n_fleet, np_, grid, splits)
            build.check(lib.brief_fused_train_wide(
                coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
                params.data_ptr(), 0 if masks is None else masks.data_ptr(),
                0 if thres is None else thres.data_ptr(),
                bufs["wp"].data_ptr(), bufs["scratch"].data_ptr(),
                bufs["partial"].data_ptr(), bufs["lossp"].data_ptr(),
                out.data_ptr(), n, n_fleet, meta_c, w0_c,
                LOSSES.index(loss_name), float(beta), grid, p["block"],
                p["smem_bytes"], splits, chunk,
                torch.cuda.current_stream(device).cuda_stream),
                "fused_train wide")
            return out
        partial = torch.empty((n_fleet, grid, width), dtype=torch.float32,
                              device=device)
        if p["layout"] == "tiled":
            build.check(lib.brief_fused_train_tiled(
                coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
                params.data_ptr(), 0 if masks is None else masks.data_ptr(),
                0 if thres is None else thres.data_ptr(),
                _slot_map(widths, p["slots"], device).data_ptr(),
                partial.data_ptr(), out.data_ptr(), n, n_fleet, meta_c,
                w0_c, LOSSES.index(loss_name), float(beta), grid,
                p["smem_bytes"],
                torch.cuda.current_stream(device).cuda_stream),
                "fused_train tiled")
            return out
        build.check(lib.brief_fused_train(
            coords.data_ptr(), values.data_ptr(), weights.data_ptr(),
            params.data_ptr(), 0 if masks is None else masks.data_ptr(),
            0 if thres is None else thres.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, n_fleet, meta_c, w0_c,
            LOSSES.index(loss_name), float(beta), grid, p["threads"],
            p["smem_bytes"], torch.cuda.current_stream(device).cuda_stream),
            "fused_train")
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
    if n_fleet == 1:    # one chain: the 1-D concatenation is the faster one
        params = torch.cat([t.reshape(-1) for layer in layers
                            for t in (layer["w"], layer["b"])])[None]
    else:
        params = torch.cat([t for layer in layers
                            for t in (layer["w"].reshape(n_fleet, -1),
                                      layer["b"])], dim=1)
    masks, mask_off, off = None, [], 0
    if unit_masks is not None:
        rows = []
        for l, mk in enumerate(unit_masks):
            if mk is None:
                mask_off.append(-1)
                continue
            if tuple(mk.shape) != (n_fleet, widths[l + 1]):
                raise ValueError(f"unit mask {l}: expected "
                                 f"{(n_fleet, widths[l + 1])}, got "
                                 f"{tuple(mk.shape)}")
            mask_off.append(off)
            off += widths[l + 1]
            rows.append(mk)
        if rows:
            masks = torch.cat(rows, dim=1).to(torch.float32).contiguous()
    mask_off += [-1] * (len(layers) - len(mask_off))
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
