"""Fused full-grid decode for plain activation chains: CUDA kernel + plain
PyTorch version.

Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_decode.py
(`_make_decode_kernel` / `_plane_coords` / `_decode_grid_padded`, entries
`fused_decode_grid` and `decode_volume`, gate `supports`, lines 75-260):
the chain's forward over every voxel of the grid, each voxel's
coordinates built from its grid index.

Bound on an H100: operations.  Every product runs on the tensor cores in
3xTF32 (mma.sync.m16n8k8; the weights split into TF32 big and small parts,
both rounded to nearest, in the B-fragment order of ops/fused_train.py
`pack_fragments`; each k-block's three products summed from zero and
added in float32, float32's accuracy, where the tensor core's own sums
truncate): 3 x the product flops at 495 TFLOP/s, beside the sines
at 67 TFLOP/s (64x512x512 at 5 x 191: ~22 ms; 64^3 at 5 x 22: ~5.5 us,
paced by the sines).  csrc/chain_tc.cuh (the tensor-core chain it
shares with ops/fused_siren.py) and csrc/fused_decode.cu say how its
design answers that.

Three forms (`choose_plan`):
  * narrow (`narrow_plan`; 5 x 22, the HiP-CT chunks 3-66x6-1): every
    layer's weights, split by each persistent block while it loads them
    (one launch a call), resident in its shared memory; each warp carries
    16 voxels through the chain with a layer's input and output in
    registers (kNT n-tiles each, NARROW_NT);
  * wide (`wide_plan`; chains of at most 256 features, e.g. the
    SingleTask default on the 64x512x512 demo volumes, 5 x 191 and
    5 x 242): blocks of 128 voxels, the pre-split weights streamed
    through shared memory in k-block slabs, each warp kNW n-tiles of all
    8 voxel tiles, the weights split once per call by pack_kernel (two
    launches a call); the layer's input in shared memory; as many slabs
    in flight as shared memory holds (up to MAX_STAGES);
  * streamed (ops/chain_stream.py, csrc/chain_stream.cuh; every chain
    with a layer wider than 256 features, e.g. 3-383x4-1 on the demo
    volume at ~20x, or 3-22213-1 at 80x with Module.phi.layers 2): thin
    end layers as reductions, square layers on tensor-core tiles of 128
    rows and 128 or 64 columns, the rows in chunks of bounded scratch.
The chain's layers and the grid's axes are rows of a table in device
memory (`chain_table`, `axis_table`; ops/chain.py layer_table), made once
per chain and grid, so neither bounds the kernel.  `supports` takes the
chains the JAX package's `supports` takes: any plain chain whose weights
take at most WEIGHT_BUDGET (32 MB), over any grid of 2 or more axes.

Coordinates: the lead axis is the affine lo + i * step (float32, no fused
multiply-add), the other axes are axis_linspace values — the TPU kernel's
formulas.  The kernel takes axis a's index of the flat voxel index v as
v // stride_a - (v // stride_{a-1}) size_a (`split_index`), with 32-bit
multiply-shift divisions (`fast_divisor`) below 2^31 voxels.  The slab
path of the JAX package (train/decode._decode_scan) uses the affine
index_to_coords on every axis; the two differ by a float32 rounding of
the coordinate, ~1e-5 in the decoded values.

`fused_decode_grid` launches the kernel for a CUDA device and calls the
plain version, `fused_decode_grid_reference`, for the CPU; there is no
fallback from one to the other.  The kernel ignores
Decompress.sample_size (it holds no per-voxel intermediate in device
memory); the plain version honours it as its slab size.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from brief_pytorch_tpu_torch.core.coords import axis_linspace, parse_coords_mode
from brief_pytorch_tpu_torch.ops import chain_stream
from brief_pytorch_tpu_torch.ops.chain import (ACTS, LayerSpec,
                                               chain_layer_specs, f32_word,
                                               i64_words, layer_table,
                                               pad_row)
from brief_pytorch_tpu_torch.ops.fast_math import fast_sin
from brief_pytorch_tpu_torch.ops.fused_train import pack_fragments
from brief_pytorch_tpu_torch.ops.tc_model import act as _act
from brief_pytorch_tpu_torch.ops.tc_model import tf32_split_nearest

SMEM_LIMIT = 232448          # bytes of shared memory one block may use (H100)
SM_SMEM = 233472             # bytes of shared memory of one SM (H100)
WEIGHT_BUDGET = 32 << 20     # bytes of W: the JAX kernel's gate
NARROW_AXES = 4              # kMaxPlaneAxes + 1: the narrow form's grids
WARPS = 8                    # warps a block, both forms
# narrow form: kNT (n-tiles of registers) -> (16-voxel m-tiles a warp,
# blocks of 8 warps per SM its launch bounds guarantee: 2 at <= 128
# registers, 1 at <= 255)
NARROW_NT = {3: (2, 2), 6: (1, 2), 9: (2, 1), 12: (1, 1)}
WIDE_M = 8                   # wide form: 16-voxel m-tiles a block tile
WIDE_STRIDE = 16 * WIDE_M + 4   # floats per activation row
MAX_STAGES = 8               # wide form: slabs in the ring, at most
BARRIER_BYTES = 16 * MAX_STAGES   # wide form: the ring's barriers
FRAG_BYTES = 512             # one B fragment: 32 lanes x 4 floats
# int32 words of a table row: sizeof ChainLayer (csrc/chain_tc.cuh) and
# GridAxis (csrc/fused_decode.cu) / 4
CHAIN_ROW_WORDS = 12
AXIS_ROW_WORDS = 8

launches = 0                 # kernel launches, for proof that a run used it
stream_launches = 0          # those in the streamed form (ops/chain_stream.py)

_SIGNATURES = {
    "brief_fused_decode": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "brief_fused_decode_stream": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p],
    "brief_fused_decode_kernels": []}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def packed_layout(widths: Sequence[int]) -> Dict[str, List[int]]:
    """Where pack_kernel puts each layer's pre-split weights: kb x nt B
    fragments of W (fin, fout) from float4 frag_off[l] (pack_fragments'
    order), then the biases, each zero-padded to 8, from float
    bias_off[l]; packed_floats in all."""
    kb = [_cdiv(f, 8) for f in widths[:-1]]
    nt = [_cdiv(f, 8) for f in widths[1:]]
    frag_off = [0]
    for k, n in zip(kb, nt):
        frag_off.append(frag_off[-1] + 32 * k * n)
    bias_off = [4 * frag_off[-1]]
    for n in nt:
        bias_off.append(bias_off[-1] + 8 * n)
    most = max(max(32 * k * n, 8 * n) for k, n in zip(kb, nt))
    return {"kb": kb, "nt": nt, "frag_off": frag_off[:-1],
            "bias_off": bias_off[:-1], "packed_floats": bias_off[-1],
            "pack_blocks": _cdiv(most, 256)}


def narrow_plan(widths: Sequence[int]) -> Optional[Dict]:
    """The narrow form: the packed weights in shared memory, kNT n-tiles
    of registers (the smallest instance holding the widest layer and the
    input's k-blocks); None past 12 of either or when the weights do not
    fit a block."""
    lay = packed_layout(widths)
    need = max(lay["nt"] + lay["kb"][:1])
    inst = min((k for k in NARROW_NT if k >= need), default=None)
    smem = 4 * lay["packed_floats"]
    if inst is None or smem > SMEM_LIMIT:
        return None
    m_tiles, reg_blocks = NARROW_NT[inst]
    blocks = min(SM_SMEM // (smem + 1024), reg_blocks)
    return {"layout": "narrow", "inst": inst, "tile": 16 * m_tiles,
            "smem_bytes": smem,
            "blocks_per_sm": blocks, "warps_per_sm": WARPS * blocks, **lay}


def wide_plan(widths: Sequence[int]) -> Dict:
    """The wide form: kNW n-tiles a warp (a layer in one pass, at most 32
    n-tiles: 256 features); the layer input's rows (8 x the most
    k-blocks) of WIDE_STRIDE floats in shared memory, beside a ring of as
    many slabs of 8 x kNW fragments as fit, up to MAX_STAGES.  Raises for
    a chain those rows would not hold (a layer or an input wider than
    256 features: chain_stream.takes), which takes the streamed form."""
    lay = packed_layout(widths)
    nw = min(4, _cdiv(max(lay["nt"]), WARPS))
    rows = 8 * max(lay["kb"])
    fixed = BARRIER_BYTES + 4 * rows * WIDE_STRIDE
    slab = WARPS * nw * FRAG_BYTES
    if max(lay["nt"]) > WARPS * nw or fixed + 2 * slab > SMEM_LIMIT:
        raise ValueError(f"chain widths {list(widths)}: wider than the wide "
                         f"form's shared memory holds (the streamed form "
                         f"takes it)")
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slab)
    return {"layout": "wide", "inst": nw, "tile": 16 * WIDE_M,
            "smem_bytes": fixed + stages * slab,
            "stages": stages, "blocks_per_sm": 1, "warps_per_sm": WARPS,
            **lay}


@functools.lru_cache(maxsize=None)
def _choose(widths: Tuple[int, ...]) -> Dict:
    if chain_stream.takes(widths):
        return chain_stream.stream_plan(widths)
    narrow = narrow_plan(widths) if widths[0] <= NARROW_AXES else None
    return narrow or wide_plan(widths)


def choose_plan(widths: Sequence[int]) -> Dict:
    """The streamed form (ops/chain_stream.py) for a chain with a layer
    wider than 256 features (chain_stream.STREAM_WIDTH); else the narrow
    form where it fits (grids of up to NARROW_AXES axes, whose coordinates
    fill k-block 0), else the wide form with its activations in shared
    memory: a chain of any depth (widths[0]: the coordinates, any
    number).  The plan states its form (`layout`, and `stream` for the
    streamed one), instance (`inst`: kNT or kNW), voxels a warp or block
    tile (`tile`), shared memory and warps per SM; only the streamed
    form keeps activations in a device scratch."""
    return dict(_choose(tuple(int(w) for w in widths)))


def chain_table(p: Dict, widths: Sequence[int], acts: LayerSpec,
                ptrs: Sequence[int]) -> List[int]:
    """The chain's table (csrc/chain_tc.cuh ChainLayer rows) for plan p:
    per layer its W and b pointers (ptrs, 2 a layer), the packed copy's
    fragment and bias offsets (in float4), widths, k-blocks, n-tiles,
    activation, w0.  Kernels 2 and 3 read the same rows."""
    if p["packed_floats"] // 4 >= 1 << 31:
        raise ValueError(f"chain widths {list(widths)}: its split weights "
                         f"({4 * p['packed_floats']:,} bytes) pass the "
                         f"kernel's 32-bit float4 offsets")
    words = []
    for l, (act, w0) in enumerate(acts):
        words += pad_row(
            i64_words(ptrs[2 * l]) + i64_words(ptrs[2 * l + 1]) +
            [p["frag_off"][l], p["bias_off"][l] // 4, widths[l],
             widths[l + 1], p["kb"][l], p["nt"][l], ACTS.index(act),
             f32_word(w0)], CHAIN_ROW_WORDS)
    return words


def axis_table(spatial: Sequence[int], index64: bool) -> List[int]:
    """The grid's axis rows (csrc/fused_decode.cu GridAxis): each axis's
    voxel stride, size, axis_linspace table offset (plane axes, as
    _plane_tables concatenates them) and the fast_divisor of its stride
    and of its size (zeros where the grid takes 64-bit division)."""
    words, off = [], 0
    for a, size in enumerate(spatial):
        stride = int(np.prod(spatial[a + 1:]))
        div = [(0, 0), (0, 0)] if index64 else [fast_divisor(stride),
                                                 fast_divisor(int(size))]
        words += pad_row(
            i64_words(stride) + [int(size), off if a else 0] +
            [i64_words(x)[0] for d in div for x in d], AXIS_ROW_WORDS)
        off += int(size) if a else 0
    return words


def fast_divisor(d: int) -> Tuple[int, int]:
    """(mul, shift) with n // d == (n * mul >> 32) >> shift for every
    0 <= n < 2^31 (mul = ceil(2^(31 + l) / d), l = ceil(log2 d), below
    2^32); (0, 0) for d = 1, which the kernel takes as n itself."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} out of range")
    if d == 1:
        return 0, 0
    l = (d - 1).bit_length()
    return ((1 << (31 + l)) + d - 1) // d, l - 1


def fast_div(n, mul: int, shift: int):
    """The kernel's n // d (csrc/fused_decode.cu fast_div) on int64
    numpy arrays."""
    n = np.asarray(n, dtype=np.int64)
    if mul == 0:
        return n
    return ((n.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32 + shift)
            ).astype(np.int64)


def split_index(v, spatial: Sequence[int]):
    """(lead, [plane axes' indices]) of flat voxel indices v < 2^31 as the
    wide form splits them (csrc/fused_decode.cu GridInput): q_a = fast_div
    of v by axis a's stride (the product of the later axes' sizes), the
    lead index q_0 and plane axis a's q_a - q_{a-1} size_a.  The narrow
    form divides by the plane, then each plane axis's size from the last:
    the same integers."""
    v = np.asarray(v, dtype=np.int64)
    q = [fast_div(v, *fast_divisor(int(np.prod(spatial[a + 1:]))))
         for a in range(len(spatial))]
    return q[0], [q[a] - q[a - 1] * int(spatial[a])
                  for a in range(1, len(spatial))]


def pack_weights(layers, widths: Sequence[int]) -> torch.Tensor:
    """pack_kernel's output (and the narrow form's shared memory) on the
    CPU: (packed_floats,) float32."""
    lay = packed_layout(widths)
    parts = [pack_fragments(layer["w"].float().cpu(), k, n,
                            tf32_split_nearest).reshape(-1)
             for layer, k, n in zip(layers, lay["kb"], lay["nt"])]
    for layer, n in zip(layers, lay["nt"]):
        b = torch.zeros(8 * n)
        b[:layer["b"].shape[0]] = layer["b"].float().cpu()
        parts.append(b)
    return torch.cat(parts)


def supports(model, spatial=None) -> bool:
    """Whether the fused decode kernel can run this φ model: a plain chain
    (SIRENPos folds into the coordinates) whose weights take at most
    WEIGHT_BUDGET bytes, over 2 or more spatial axes (the JAX kernel's
    gate, pallas_decode.py:231-247)."""
    if spatial is not None and len(spatial) < 2:
        return False
    spec = getattr(model, "spec", None)
    if spec is None:
        return False
    try:
        chain_layer_specs(spec)
    except ValueError:
        return False
    widths = [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]
    return sum(4 * a * b for a, b in zip(widths[:-1], widths[1:])) <= \
        WEIGHT_BUDGET


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
def grid_coords(spatial: Sequence[int], mode: str = "n11", *,
                enc_periods=None, device="cpu",
                voxels: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(stop - start, len(spatial)) float32 coordinates of the flat voxels
    [start, stop) (default: all) as the kernel builds them: the lead axis
    lo + i * step (two roundings, no fused multiply-add), the plane axes
    from the axis_linspace tables, SIRENPos-warped where enc_periods is
    given."""
    spatial = tuple(int(s) for s in spatial)
    plane = int(np.prod(spatial[1:]))
    start, stop = (0, int(np.prod(spatial))) if voxels is None else voxels
    tables = _plane_tables(spatial, mode, enc_periods, device)
    lo, step, scale = _lead_affine(spatial, mode, enc_periods)
    v = torch.arange(start, stop, device=device)
    lead = torch.div(v, plane, rounding_mode="floor")
    p = v - lead * plane
    z0 = torch.tensor(lo, dtype=torch.float32, device=device) + \
        lead.to(torch.float32) * torch.tensor(step, dtype=torch.float32,
                                              device=device)
    if enc_periods is not None:
        z0 = fast_sin(torch.tensor(scale, device=device) * z0)
    off = sum(spatial[1:])
    rest = []
    for n in reversed(spatial[1:]):
        off -= n
        rest.append(tables[off + torch.remainder(p, n)])
        p = torch.div(p, n, rounding_mode="floor")
    return torch.stack([z0] + rest[::-1], dim=1)


def fused_decode_grid_reference(layers, spatial: Sequence[int],
                                acts: LayerSpec, mode: str = "n11", *,
                                enc_periods=None,
                                slab: Optional[int] = None,
                                voxels: Optional[Tuple[int, int]] = None
                                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, `slab` voxels at a time
    (default: all at once), on the device of the weights; only the flat
    voxels [start, stop) when `voxels` is given."""
    device = layers[0]["w"].device
    first, stop = (0, int(np.prod(spatial))) if voxels is None else voxels
    slab = stop - first if not slab else int(slab)
    outs = []
    for start in range(first, stop, slab):
        h = grid_coords(spatial, mode, enc_periods=enc_periods,
                        device=device,
                        voxels=(start, min(stop, start + slab)))
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
    if len(spatial) < 2:
        raise ValueError("fused decode needs 2 or more spatial axes")
    device = layers[0]["w"].device
    if device.type == "cpu":
        return fused_decode_grid_reference(layers, spatial, acts, mode,
                                           enc_periods=enc_periods, slab=slab)
    if device.type != "cuda":
        raise ValueError(f"fused_decode_grid runs on cuda or cpu, not {device}")
    global launches, stream_launches
    from brief_pytorch_tpu_torch.ops import build

    widths = [len(spatial)] + [int(l["w"].shape[1]) for l in layers]
    for l, layer in enumerate(layers):
        if tuple(layer["w"].shape) != (widths[l], widths[l + 1]) or \
                tuple(layer["b"].shape) != (widths[l + 1],):
            raise ValueError(f"layer {l}: w {tuple(layer['w'].shape)} / b "
                             f"{tuple(layer['b'].shape)} do not chain from "
                             f"{len(spatial)} coordinates")
        for t in (layer["w"], layer["b"]):
            if t.device != device or t.dtype != torch.float32:
                raise ValueError(f"weights: expected float32 on {device}")
    if len(acts) != len(layers):
        raise ValueError("one (act, w0) per layer")
    p = choose_plan(widths)
    pop = int(np.prod(spatial))
    if p.get("stream"):
        out = _decode_stream(p, layers, widths, spatial, acts, mode,
                             enc_periods, pop, device)
        launches += 1
        stream_launches += 1
        return out
    n_tiles = _cdiv(pop, p["tile"])
    if n_tiles >= 1 << 31:
        raise ValueError(f"grid {spatial}: {pop} voxels is too many")
    tables = _plane_tables(spatial, mode, enc_periods, device)
    lo, step, scale = _lead_affine(spatial, mode, enc_periods)
    index64 = pop >= 1 << 31
    meta = [len(layers), widths[0], widths[-1], int(enc_periods is not None),
            int(index64), n_tiles, p.get("stages", 0), 8 * p["kb"][0],
            p["pack_blocks"]]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    fmeta_c = (ctypes.c_float * 3)(lo, step, scale)
    wb = [t.contiguous() for layer in layers for t in (layer["w"], layer["b"])]
    ptrs = tuple(t.data_ptr() for t in wb)
    table, head = layer_table(
        ("decode", tuple(widths), tuple(acts), ptrs, spatial),
        lambda: chain_table(p, widths, acts, ptrs) +
        axis_table(spatial, index64), device)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_block = p["tile"] * (WARPS if p["layout"] == "narrow" else 1)
    grid = min(_cdiv(pop, per_block), sms * p["blocks_per_sm"])
    form = 0 if p["layout"] == "narrow" else 1
    out = torch.empty((pop, widths[-1]), dtype=torch.float32, device=device)
    packed = torch.empty(p["packed_floats"] if form else 0,
                         dtype=torch.float32, device=device)
    lib = build.library("fused_decode", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        build.check(lib.brief_fused_decode(
            tables.data_ptr(), out.data_ptr(),
            packed.data_ptr() if form else None, table.data_ptr(),
            head, pop, meta_c, fmeta_c, form, p["inst"], grid, p["smem_bytes"],
            torch.cuda.current_stream(device).cuda_stream), "fused_decode")
    launches += 1
    return out


def _decode_stream(p, layers, widths, spatial, acts, mode, enc_periods,
                   pop: int, device) -> torch.Tensor:
    """One grid decode in the streamed form (csrc/chain_stream.cuh)."""
    from brief_pytorch_tpu_torch.ops import build
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    call = chain_stream.stream_call(p, pop, sms)
    tables = _plane_tables(spatial, mode, enc_periods, device)
    lo, step, scale = _lead_affine(spatial, mode, enc_periods)
    index64 = pop >= 1 << 31
    meta = [len(layers), widths[0], widths[-1], int(enc_periods is not None),
            int(index64), call["R"], call["S"], p["n_fb"],
            chain_stream.pack_blocks(p, widths), call["h_floats"]]
    wb = [t.contiguous() for layer in layers for t in (layer["w"], layer["b"])]
    ptrs = tuple(t.data_ptr() for t in wb)
    table, head = layer_table(
        ("decode-stream", tuple(widths), tuple(acts), ptrs, spatial),
        lambda: chain_stream.stream_table(p, widths, acts, ptrs) +
        axis_table(spatial, index64), device)
    out = torch.empty((pop, widths[-1]), dtype=torch.float32, device=device)
    bufs = chain_stream.buffers(p, call, device)
    lib = build.library("fused_decode", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        build.check(lib.brief_fused_decode_stream(
            tables.data_ptr(), out.data_ptr(), chain_stream.ptr(bufs["wp"]),
            chain_stream.ptr(bufs["h"]), chain_stream.ptr(bufs["part"]),
            table.data_ptr(), head, pop,
            (ctypes.c_int * len(meta))(*meta),
            (ctypes.c_float * 3)(lo, step, scale),
            torch.cuda.current_stream(device).cuda_stream),
            "fused_decode stream")
    return out


def kernels_launched() -> int:
    """Device kernels the decode library has launched in this process (its
    own count, kept where it launches them): one a call in the narrow form,
    two in the wide form (pack_kernel, then the chain), and
    chain_stream.stream_call's `kernels` in the streamed form.  Needs the
    card."""
    from brief_pytorch_tpu_torch.ops import build
    return build.library("fused_decode",
                         _SIGNATURES).brief_fused_decode_kernels()


def decode_volume(model, params, spatial: Sequence[int], mode: str, *,
                  slab: Optional[int] = None) -> torch.Tensor:
    """(prod(spatial), Cout) decode of a supported φ model."""
    spec = model.spec
    enc_periods = tuple(float(t) for t in spec.encoder_cfg) \
        if spec.encoder == "sirenpos" else None
    return fused_decode_grid(params["layers"], spatial,
                             chain_layer_specs(spec), mode,
                             enc_periods=enc_periods, slab=slab)
