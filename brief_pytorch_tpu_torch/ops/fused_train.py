"""Fused train-step gradients for plain activation chains: CUDA kernel +
plain PyTorch version.

Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_train.py
(`_make_train_kernel` / `_fused_grads_padded`, entry `fused_train_grads`,
lines 70-357).  One kernel runs, per coordinate tile, the chain's forward
(storing each activation and its derivative), the weighted datal2 /
datasmoothl1 loss with the weight_thres override, and a backward with no
transcendentals; a second pass adds the blocks' partial sums in a fixed
order.  It returns (loss, grads) already divided by N * Cout and replaces
autograd in train/fit.py.

Bound on an H100: operations.  At the default run's shapes (SIREN 5 x 22,
N = 262,144) the call moves ~5 MB but does ~3 GFLOP of float32 work
(~45 us at 67 TFLOP/s); csrc/fused_train.cu says how its design answers
that.

`fused_train_grads` launches the kernel for CUDA tensors and calls the
plain version, `fused_train_grads_reference`, for CPU tensors; there is
no fallback from one to the other.  Scope of this port: acts sine, relu,
sigmoid, none; losses datal2, datasmoothl1; a static weight_thres;
float32.  The TPU kernel's unit masks, traced threshold and bf16 inputs
(the DivideTask fleet and `half`) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from brief_pytorch_tpu_torch.ops.chain import ACTS, LayerSpec, chain_layer_specs
from brief_pytorch_tpu_torch.ops.fast_math import fast_sincos

LOSSES = ("datal2", "datasmoothl1")
SMEM_LIMIT = 232448          # bytes of shared memory one block may use (H100)
SM_SMEM = 233472             # bytes of shared memory of one SM (H100)
BLOCKS = (128, 64, 32)       # coordinates per tile (= threads per block)

launches = 0                 # kernel launches, for proof that a run used it

_SIGNATURES = {
    "brief_fused_train_occupancy": [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p],
    "brief_fused_train": [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def plan(widths: Sequence[int], block: int) -> Dict:
    """Shared-memory layout (in floats) of the kernel for a chain of
    `widths` = (c_in, f_1, ..., c_out) and `block` coordinates per tile.

    The weights W (fin, round8(fout)) and W^T (fout, round8(fin)) and the
    bias of every layer, the per-block gradient accumulator, a loss
    reduction buffer, then the activation rows (coordinates, then h_l and
    d_l of every layer), each row block + 1 floats long."""
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
            "smem_bytes": 4 * (act_off + row * stride)}


def choose_plan(widths: Sequence[int]):
    """The tile size that keeps the most coordinates resident per SM (an
    H100 SM has 228 KB of shared memory, 1 KB of it reserved per block),
    or None when even 32 coordinates per tile do not fit a block's 227 KB
    (the chain then trains through autograd)."""
    if len(widths) - 1 > 16:
        return None
    best, best_resident = None, 0
    for block in BLOCKS:
        p = plan(widths, block)
        if p["smem_bytes"] > SMEM_LIMIT:
            continue
        resident = block * min(2048 // block,
                               SM_SMEM // (p["smem_bytes"] + 1024))
        if resident > best_resident:
            best, best_resident = p, resident
    return best


def supports_training(model, loss_name: str) -> bool:
    """Whether the fused train-grad kernel can run this φ model + loss."""
    if loss_name not in LOSSES:
        return False
    spec = getattr(model, "spec", None)
    if spec is None:
        return False
    try:
        chain_layer_specs(spec)
    except ValueError:
        return False
    widths = [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]
    return choose_plan(widths) is not None


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
                                beta: float = 0.01, weight_thres=None):
    """The kernel's function in plain PyTorch, feature-major: the forward
    stores h_l and d_l, the backward re-reads them (no autograd)."""
    hs, ds = [coords_t], []
    h = coords_t
    for layer, (act, w0) in zip(layers, acts):
        z = layer["w"].T @ h + layer["b"][:, None]
        h, d = _act_fwd(z, act, w0)
        hs.append(h)
        ds.append(d)
    pred = h
    w_eff = weights_t
    if weight_thres:
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
    loss = torch.sum(w_eff * l_elem)
    if ds[-1] is not None:
        g = g * ds[-1]
    m = float(coords_t.shape[1] * values_t.shape[0])
    grads: List[Dict] = [None] * len(layers)
    for l in range(len(layers) - 1, -1, -1):
        grads[l] = {"w": (hs[l] @ g.T) / m, "b": g.sum(dim=1) / m}
        if l > 0:
            g = layers[l]["w"] @ g
            if ds[l - 1] is not None:
                g = g * ds[l - 1]
    return loss / m, {"layers": grads}


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------
_OCCUPANCY: Dict[Tuple[int, int, int], int] = {}


def _grid(lib, device: torch.device, p: Dict, n: int) -> int:
    """Persistent grid: as many blocks as fit on the card at once, but no
    more than there are tiles."""
    key = (device.index or 0, p["block"], p["smem_bytes"])
    if key not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        from brief_pytorch_tpu_torch.ops import build
        build.check(lib.brief_fused_train_occupancy(
            p["block"], p["smem_bytes"], ctypes.addressof(per_sm),
            ctypes.addressof(sms)), "fused_train occupancy")
        _OCCUPANCY[key] = max(1, per_sm.value) * sms.value
    return max(1, min(_OCCUPANCY[key], -(-n // p["block"])))


def fused_train_grads(layers, coords_t: torch.Tensor, values_t: torch.Tensor,
                      weights_t: torch.Tensor, acts: LayerSpec, *,
                      loss_name: str, beta: float = 0.01, weight_thres=None):
    """(loss, grads) for weighted-loss fitting of a plain activation chain.

    layers: [{'w': (fin, fout), 'b': (fout,)}, ...] float32
    coords_t: (C, N); values_t / weights_t: (Cout, N) — feature-major,
    contiguous.  grads: {"layers": [{'w', 'b'}]} shaped like `layers`,
    loss and grads divided by N * Cout.  CUDA tensors launch the kernel;
    CPU tensors take the plain version.
    """
    if coords_t.device.type == "cpu":
        return fused_train_grads_reference(
            layers, coords_t, values_t, weights_t, acts,
            loss_name=loss_name, beta=beta, weight_thres=weight_thres)
    if not coords_t.is_cuda:
        raise ValueError(f"fused_train_grads runs on cuda or cpu, not "
                         f"{coords_t.device}")
    global launches
    from brief_pytorch_tpu_torch.ops import build

    device = coords_t.device
    c_in, n = coords_t.shape
    c_out = values_t.shape[0]
    widths = [c_in] + [int(l["w"].shape[1]) for l in layers]
    for l, layer in enumerate(layers):
        if tuple(layer["w"].shape) != (widths[l], widths[l + 1]) or \
                tuple(layer["b"].shape) != (widths[l + 1],):
            raise ValueError(f"layer {l}: w {tuple(layer['w'].shape)} / b "
                             f"{tuple(layer['b'].shape)} do not chain")
    if widths[-1] != c_out or tuple(weights_t.shape) != (c_out, n) or \
            tuple(values_t.shape) != (c_out, n):
        raise ValueError("values/weights must be (Cout, N) matching coords "
                         "(C, N) and the last layer")
    for name, x in (("coords", coords_t), ("values", values_t),
                    ("weights", weights_t)):
        if x.device != device or x.dtype != torch.float32 or \
                not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"on {device}")
    if loss_name not in LOSSES:
        raise NotImplementedError(loss_name)
    if len(acts) != len(layers):
        raise ValueError("one (act, w0) per layer")
    p = choose_plan(widths)
    if p is None:
        raise ValueError(f"chain widths {widths} exceed the kernel's shared "
                         "memory (see supports_training)")
    params = torch.cat([t for layer in layers
                        for t in (layer["w"].reshape(-1), layer["b"])])
    if params.device != device or params.dtype != torch.float32:
        raise ValueError(f"weights: expected float32 on {device}")
    meta = [len(layers), c_in, c_out, p["n_params"], p["stride"],
            p["acc_off"], p["red_off"], p["act_off"]]
    for l, (act, _) in enumerate(acts):
        meta += [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
                 p["sw_off"][l], p["swt_off"][l], p["sb_off"][l],
                 p["h_row"][l], p["dg_row"][l]]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    w0_c = (ctypes.c_float * len(acts))(*[float(w0) for _, w0 in acts])

    lib = build.library("fused_train", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        grid = _grid(lib, device, p, n)
        width = p["n_params"] + 1
        partial = torch.empty((grid, width), dtype=torch.float32,
                              device=device)
        out = torch.empty((width,), dtype=torch.float32, device=device)
        build.check(lib.brief_fused_train(
            coords_t.data_ptr(), values_t.data_ptr(), weights_t.data_ptr(),
            params.data_ptr(), partial.data_ptr(), out.data_ptr(), n, meta_c,
            w0_c, LOSSES.index(loss_name), float(beta),
            int(bool(weight_thres)), float(weight_thres or 0.0), grid,
            p["block"], p["smem_bytes"],
            torch.cuda.current_stream(device).cuda_stream), "fused_train")
    launches += 1
    grads = []
    for l in range(len(layers)):
        fin, fout = widths[l], widths[l + 1]
        o = p["p_off"][l]
        grads.append({"w": out[o:o + fin * fout].view(fin, fout),
                      "b": out[o + fin * fout:o + fin * fout + fout]})
    return out[p["n_params"]], {"layers": grads}
