"""Fused full-grid decode for plain activation chains: CUDA kernel + plain
PyTorch version.

Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_decode.py
(`_make_decode_kernel` / `_plane_coords` / `_decode_grid_padded`, entries
`fused_decode_grid` and `decode_volume`, gate `supports`, lines 75-260):
the chain's forward over every voxel of the grid, each voxel's
coordinates built from its grid index.

Bound on an H100: operations.  A 256^3 grid at f = 22 writes 67 MB but
does ~75 GFLOP of float32 work (~1.1 ms at 67 TFLOP/s);
csrc/fused_decode.cu says how its design answers that.

Two forms: chains whose weights fit a block's shared memory beside the
activation buffers (`plan`, e.g. 5 x 22) keep all weights there; wider
ones (`wide_plan`, e.g. the SingleTask default on the 64x512x512 demo
volumes, 5 x 191 and 5 x 242) stream them through shared memory in slabs
(ops/wide.py, csrc/wide.cuh).  `supports` takes the chains the JAX
package's `supports` takes (weights up to 32 MB, at least 2 spatial
axes) within the port's limits: up to MAX_LAYERS layers, 2 to 4 spatial
axes, a widest layer that fits the wide form's 8-voxel tile.

Coordinates: the lead axis is the affine lo + i * step (float32, no fused
multiply-add), the other axes are axis_linspace values — the TPU kernel's
formulas.  The slab path of the JAX package (train/decode._decode_scan)
uses the affine index_to_coords on every axis; the two differ by a float32
rounding of the coordinate, ~1e-5 in the decoded values.

`fused_decode_grid` launches the kernel for a CUDA device and calls the
plain version, `fused_decode_grid_reference`, for the CPU; there is no
fallback from one to the other.  The kernel ignores
Decompress.sample_size (it holds no per-voxel intermediate in device
memory); the plain version honours it as its slab size.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import axis_linspace, parse_coords_mode
from brief_pytorch_tpu_torch.ops import wide
from brief_pytorch_tpu_torch.ops.chain import ACTS, LayerSpec, chain_layer_specs
from brief_pytorch_tpu_torch.ops.fast_math import fast_sin

SMEM_LIMIT = 232448          # bytes of shared memory one block may use (H100)
SM_SMEM = 233472             # bytes of shared memory of one SM (H100)
BLOCKS = (128, 64, 32)       # voxels per block (= threads per block)
MAX_PLANE_AXES = 3
MAX_LAYERS = 16              # kMaxLayers of csrc/chain.cuh
WEIGHT_BUDGET = 32 << 20     # bytes of W: the JAX kernel's gate

launches = 0                 # kernel launches, for proof that a run used it

_SIGNATURES = {
    "brief_fused_decode": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "brief_fused_decode_wide": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]}


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def plan(widths: Sequence[int], block: int) -> Dict:
    """Shared-memory layout (in floats): per layer W (fin, round8(fout))
    and the bias, then two activation buffers of max(widths) rows of
    `block` floats."""
    off = 0
    p_off, sw_off, sb_off = [], [], []
    n_params = 0
    for l in range(len(widths) - 1):
        fin, fout = widths[l], widths[l + 1]
        p_off.append(n_params)
        n_params += fin * fout + fout
        sw_off.append(off)
        off += fin * _round8(fout)
        sb_off.append(off)
        off += _round8(fout)
    buf_rows = max(widths)
    return {"layout": "narrow", "p_off": p_off, "sw_off": sw_off,
            "sb_off": sb_off, "act_off": off, "buf_rows": buf_rows,
            "stride": block, "block": block,
            "smem_bytes": 4 * (off + 2 * buf_rows * block)}


def wide_plan(widths: Sequence[int], tile: int) -> Dict:
    """The wide form's layout for `tile` voxels per block (4 * tile
    threads): two buffers of rows_max rows of `tile` floats and two weight
    slabs in shared memory; the weights packed in device memory."""
    rows = wide.rows_max(widths)
    return {"layout": "wide", "block": tile, "threads": 4 * tile,
            "rows_max": rows, **wide.layer_meta(widths),
            "smem_bytes": 4 * (2 * rows * tile + 2 * wide.SLAB)}


def choose_plan(widths: Sequence[int]) -> Optional[Dict]:
    """The largest block whose weights fit a block's shared memory beside
    its activation buffers; else the wide form's tile that keeps the most
    voxels resident per SM; None past MAX_LAYERS layers or when even the
    wide form's 8-voxel tile does not fit."""
    if len(widths) - 1 > MAX_LAYERS:
        return None
    for block in BLOCKS:
        p = plan(widths, block)
        if p["smem_bytes"] <= SMEM_LIMIT:
            return p
    tile = wide.choose_tile(lambda t: wide_plan(widths, t)["smem_bytes"],
                            SMEM_LIMIT, SM_SMEM)
    return None if tile is None else wide_plan(widths, tile)


def supports(model, spatial=None) -> bool:
    """Whether the fused decode kernel can run this φ model: a plain chain
    (SIRENPos folds into the coordinates) whose weights take at most
    WEIGHT_BUDGET bytes (the JAX kernel's gate) and which choose_plan
    holds, over 2 to 4 spatial axes."""
    if spatial is not None and not 2 <= len(spatial) <= MAX_PLANE_AXES + 1:
        return False
    spec = getattr(model, "spec", None)
    if spec is None:
        return False
    try:
        chain_layer_specs(spec)
    except ValueError:
        return False
    widths = [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]
    if sum(4 * a * b for a, b in zip(widths[:-1], widths[1:])) > \
            WEIGHT_BUDGET:
        return False
    return choose_plan(widths) is not None


def _plane_tables(spatial: Sequence[int], mode: str, enc_periods, device
                  ) -> torch.Tensor:
    """axis_linspace of every plane axis (all but the first), warped by the
    SIRENPos encoder when enc_periods is given, concatenated."""
    parts = []
    for axis, n in enumerate(spatial[1:]):
        v = axis_linspace(n, mode, device=device)
        if enc_periods is not None:
            v = fast_sin((2.0 * math.pi / enc_periods[axis + 1]) * v)
        parts.append(v)
    return torch.cat(parts)


def _lead_affine(spatial, mode, enc_periods):
    """(lo, step, enc_scale0) of the lead-axis coordinate, as float32."""
    lo, hi = parse_coords_mode(mode)
    step = 0.0 if spatial[0] == 1 else (hi - lo) / (spatial[0] - 1)
    scale = 0.0 if enc_periods is None else 2.0 * math.pi / enc_periods[0]
    return float(np.float32(lo)), float(np.float32(step)), \
        float(np.float32(scale))


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def _act(z: torch.Tensor, act: str, w0: float) -> torch.Tensor:
    if act == "sine":
        return fast_sin(w0 * z)
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "none":
        return z
    raise ValueError(act)


def fused_decode_grid_reference(layers, spatial: Sequence[int],
                                acts: LayerSpec, mode: str = "n11", *,
                                enc_periods=None,
                                slab: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, `slab` voxels at a time
    (default: all at once), on the device of the weights."""
    spatial = tuple(int(s) for s in spatial)
    device = layers[0]["w"].device
    pop = int(np.prod(spatial))
    plane = pop // spatial[0]
    tables = _plane_tables(spatial, mode, enc_periods, device)
    lo, step, scale = _lead_affine(spatial, mode, enc_periods)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    step_t = torch.tensor(step, dtype=torch.float32, device=device)
    slab = pop if not slab else int(slab)
    outs = []
    for start in range(0, pop, slab):
        v = torch.arange(start, min(pop, start + slab), device=device)
        lead = torch.div(v, plane, rounding_mode="floor")
        p = v - lead * plane
        z0 = lo_t + lead.to(torch.float32) * step_t
        if enc_periods is not None:
            z0 = fast_sin(torch.tensor(scale, device=device) * z0)
        comps = [z0]
        off = sum(spatial[1:])
        rest = []
        for n in reversed(spatial[1:]):
            off -= n
            rest.append(tables[off + torch.remainder(p, n)])
            p = torch.div(p, n, rounding_mode="floor")
        comps += rest[::-1]
        h = torch.stack(comps, dim=1)
        for layer, (act, w0) in zip(layers, acts):
            h = _act(h @ layer["w"] + layer["b"], act, w0)
        outs.append(h)
    return torch.cat(outs)


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------
def fused_decode_grid(layers, spatial: Sequence[int], acts: LayerSpec,
                      mode: str = "n11", *, enc_periods=None,
                      slab: Optional[int] = None) -> torch.Tensor:
    """Evaluate an activation chain over the full voxel grid.

    layers: [{'w': (fin, fout), 'b': (fout,)}, ...] float32.  Returns
    (prod(spatial), Cout) float32 in row-major voxel order, on the weights'
    device.  CUDA weights launch the kernel (`slab` is ignored); CPU
    weights take the plain version in slabs of `slab` voxels.
    """
    spatial = tuple(int(s) for s in spatial)
    if not 2 <= len(spatial) <= MAX_PLANE_AXES + 1:
        raise ValueError("fused decode needs 2 to 4 spatial axes")
    device = layers[0]["w"].device
    if device.type == "cpu":
        return fused_decode_grid_reference(layers, spatial, acts, mode,
                                           enc_periods=enc_periods, slab=slab)
    if device.type != "cuda":
        raise ValueError(f"fused_decode_grid runs on cuda or cpu, not {device}")
    global launches
    from brief_pytorch_tpu_torch.ops import build

    widths = [len(spatial)] + [int(l["w"].shape[1]) for l in layers]
    for l, layer in enumerate(layers):
        if tuple(layer["w"].shape) != (widths[l], widths[l + 1]) or \
                tuple(layer["b"].shape) != (widths[l + 1],):
            raise ValueError(f"layer {l}: w {tuple(layer['w'].shape)} / b "
                             f"{tuple(layer['b'].shape)} do not chain from "
                             f"{len(spatial)} coordinates")
    if len(acts) != len(layers):
        raise ValueError("one (act, w0) per layer")
    p = choose_plan(widths)
    if p is None:
        raise ValueError(f"chain widths {widths}: more than {MAX_LAYERS} "
                         "layers or a layer wider than the wide form's "
                         "tile holds (see supports)")
    params = torch.cat([t for layer in layers
                        for t in (layer["w"].reshape(-1), layer["b"])])
    if params.device != device or params.dtype != torch.float32:
        raise ValueError(f"weights: expected float32 on {device}")
    tables = _plane_tables(spatial, mode, enc_periods, device)
    lo, step, scale = _lead_affine(spatial, mode, enc_periods)
    n_plane = len(spatial) - 1
    sizes = list(spatial[1:]) + [1] * (MAX_PLANE_AXES - n_plane)
    table_off = list(np.cumsum([0] + list(spatial[1:]))[:n_plane]) + \
        [0] * (MAX_PLANE_AXES - n_plane)
    if p["layout"] == "wide":
        meta = [len(layers), widths[0], widths[-1], p["rows_max"], n_plane,
                int(enc_periods is not None), p["n_params"],
                p["wp_off"][-1]]
    else:
        meta = [len(layers), widths[0], widths[-1], p["stride"],
                p["act_off"], p["buf_rows"], n_plane,
                int(enc_periods is not None)]
    meta += sizes + [int(t) for t in table_off]
    for l, (act, _) in enumerate(acts):
        meta += [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l]]
        meta += [p["wp_off"][l], p["colpad"][l]] if p["layout"] == "wide" \
            else [p["sw_off"][l], p["sb_off"][l]]
    fmeta = [lo, step, scale] + [float(w0) for _, w0 in acts]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    fmeta_c = (ctypes.c_float * len(fmeta))(*fmeta)

    pop = int(np.prod(spatial))
    out = torch.empty((pop, widths[-1]), dtype=torch.float32, device=device)
    lib = build.library("fused_decode", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        if p["layout"] == "wide":
            wp = torch.empty(p["wp_off"][-1], dtype=torch.float32,
                             device=device)
            build.check(lib.brief_fused_decode_wide(
                params.data_ptr(), wp.data_ptr(), tables.data_ptr(),
                out.data_ptr(), pop, meta_c, fmeta_c, p["block"],
                p["smem_bytes"],
                torch.cuda.current_stream(device).cuda_stream),
                "fused_decode wide")
            launches += 1
            return out
        build.check(lib.brief_fused_decode(
            params.data_ptr(), tables.data_ptr(), out.data_ptr(), pop, meta_c,
            fmeta_c, p["block"], p["smem_bytes"],
            torch.cuda.current_stream(device).cuda_stream), "fused_decode")
    launches += 1
    return out


def decode_volume(model, params, spatial: Sequence[int], mode: str, *,
                  slab: Optional[int] = None) -> torch.Tensor:
    """(prod(spatial), Cout) decode of a supported φ model."""
    spec = model.spec
    enc_periods = tuple(float(t) for t in spec.encoder_cfg) \
        if spec.encoder == "sirenpos" else None
    return fused_decode_grid(params["layers"], spatial,
                             chain_layer_specs(spec), mode,
                             enc_periods=enc_periods, slab=slab)
