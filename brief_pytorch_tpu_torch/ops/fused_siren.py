"""Fused batch-major forward of a plain activation chain for explicitly
given coordinates: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel of brief_pytorch_tpu/ops/pallas_siren.py
(`_make_kernel` / `_fused_forward`, entry `fused_chain_apply` with its
custom VJP, `supports`, `make_fused_apply`, lines 79-202):
h <- act_l(w0_l * (h @ W_l + b_l)) for every layer, coords (N, C) ->
(N, Cout), with no activation touching device memory between layers.  The
gradient re-runs the plain chain under autograd (the JAX package has no
backward kernel here either).

Bound on an H100: operations.  SIREN 5 x 22 on N = 262,144 coordinates
moves ~4.2 MB but does ~0.8 GFLOP of products (3xTF32 on the tensor
cores: ~5 us) and 88 sines a coordinate (~5.5 us on the CUDA cores).

The kernel is the decode kernel's tensor-core chain (csrc/chain_tc.cuh,
ops/fused_decode.py) with layer 0's input read from the rows of the
(N, C) array (csrc/fused_siren.cu).  `choose_plan` states its form as
fused_decode's plans do:
  * narrow (`fused_decode.narrow_plan`: the pre-split weights fit a
    block's shared memory, at most 12 n-tiles and input k-blocks): each
    block splits the weights while it loads them, so a call is one
    launch;
  * wide (`fused_decode.wide_plan`, every other chain of at most 256
    features, C included): the weights split once per call and streamed
    through a TMA slab ring, 128-row tiles, the activations in shared
    memory;
  * streamed (ops/chain_stream.py, csrc/chain_stream.cuh; a layer or the
    input wider than 256 features): thin end layers as reductions,
    square layers on tensor-core tiles of 128 rows and 128 or 64
    columns, the rows in chunks.
It takes every plain chain, of any depth and width and any C: the
chain's layers are rows of a table in device memory
(`fused_decode.chain_table`, `chain_stream.stream_table`).
Its sums keep float32's accuracy where the tensor core's own truncate
(each k-block's three 3xTF32 products summed from zero and added in
float32, the small parts rounded: chain_tc.cuh's sums, kernel 2's too);
`chain_tc_model` is that arithmetic on the CPU, through
`mma_tf32_model`, the card's mma.sync sum bit for bit.

`fused_chain_apply` launches the kernel for CUDA tensors and calls the
plain version, `fused_chain_apply_reference`, for CPU tensors; there is no
fallback from one to the other.  Scope: acts sine, relu, sigmoid, none;
float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from brief_pytorch_tpu_torch.ops import chain_stream, fused_decode
from brief_pytorch_tpu_torch.ops.chain import (LayerSpec, chain_layer_specs,
                                               layer_table, make_pre_encode)
from brief_pytorch_tpu_torch.ops.fused_decode import WARPS, chain_table
from brief_pytorch_tpu_torch.ops.tc_model import (  # noqa: F401
    act as _act, mma_tf32_model, tf32_split, tf32_split_nearest)

launches = 0                 # kernel launches, for proof that a run used it
stream_launches = 0          # those in the streamed form (ops/chain_stream.py)

_SIGNATURES = {"brief_fused_siren": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "brief_fused_siren_stream": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]}


@functools.lru_cache(maxsize=None)
def _choose(widths: Tuple[int, ...]) -> Dict:
    if chain_stream.takes(widths):
        return chain_stream.stream_plan(widths)
    return fused_decode.narrow_plan(widths) or \
        fused_decode.wide_plan(widths)


def choose_plan(widths: Sequence[int]) -> Dict:
    """The streamed form (ops/chain_stream.py) for a chain with a layer (or
    an input) wider than 256 features (chain_stream.STREAM_WIDTH), else
    the narrow form where it fits, else the wide form with its activations
    in shared memory, for a chain of any depth.  The plan states its form
    (`layout`, and `stream` for the streamed one), instance (`inst`: kNT
    or kNW), rows a warp or block tile (`tile`), shared memory
    (`smem_bytes`) and warps per SM; only the streamed form keeps
    activations in a device scratch."""
    return dict(_choose(tuple(int(w) for w in widths)))



def chain_widths(spec) -> List[int]:
    return [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]


def supports(model) -> bool:
    """Whether the fused kernel can run this φ model: a plain chain of any
    depth and width (SIRENPos folds into the coordinates), as the JAX
    package's `supports` (pallas_siren.py:179-190)."""
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
def fused_chain_apply_reference(layers, coords: torch.Tensor,
                                acts: LayerSpec) -> torch.Tensor:
    """The kernel's function in plain PyTorch (autograd-able): the JAX
    package's `_jnp_chain`.  The sine is fast_sin, whose gradient is the
    polynomial's derivative, not fast_sin_cached's cos residual."""
    h = coords
    for layer, (act, w0) in zip(layers, acts):
        h = _act(h @ layer["w"] + layer["b"], act, w0)
    return h


# --------------------------------------------------------------------------
# the kernel's arithmetic on the CPU
# --------------------------------------------------------------------------
def chain_tc_model(layers, coords: torch.Tensor, acts: LayerSpec,
                   nearest: bool = True, plan: Optional[Dict] = None
                   ) -> torch.Tensor:
    """The chain as csrc/chain_tc.cuh computes it on an H100, on the CPU:
    layer 0's input zero-padded to k-blocks of 8 features, the bias
    starting each accumulator, then per k-block the 3xTF32 terms a_small
    b_big, a_big b_small, a_big b_big through mma_tf32_model.  nearest
    (the sums of kernels 2 and 3): both operands split by
    tf32_split_nearest, the three terms summed from zero and added to the
    accumulator in float32; else (the tensor core's own sums, which the
    kernels took before) split by tc_model.tf32_split and summed into
    the accumulator.  Rows are independent, so no tiles are needed; the
    k-block sums are independent too and go in batches of k-blocks.
    Given the streamed form's plan (`stream`), its arithmetic
    (chain_stream.stream_model); the narrow and wide forms' plans change
    nothing.
    Kernel 2's rows are its voxels' coordinates
    (fused_decode.grid_coords)."""
    if plan is not None and plan.get("stream"):
        return chain_stream.stream_model(layers, coords, acts, plan)
    split = tf32_split_nearest if nearest else tf32_split
    n, c_in = coords.shape
    h = torch.zeros(n, -(-c_in // 8) * 8)
    h[:, :c_in] = coords.float()
    for layer, (act, w0) in zip(layers, acts):
        w = layer["w"].float().cpu()
        fin, fout = w.shape
        wp = torch.zeros(h.shape[1], fout)
        wp[:fin] = w
        bb, bs = split(wp)
        c = layer["b"].float().cpu().expand(n, -1).clone()
        kb = wp.shape[0] // 8
        ab, as_ = split(h.view(n, kb, 8).transpose(0, 1).contiguous())
        bb, bs = bb.view(kb, 8, fout), bs.view(kb, 8, fout)
        if nearest:
            step = max(1, (1 << 22) // (n * 9 * fout))    # k-blocks a batch
            for k0 in range(0, kb, step):
                k = slice(k0, k0 + step)
                s = mma_tf32_model(torch.zeros(ab[k].shape[0], n, fout),
                                   as_[k], bb[k])
                s = mma_tf32_model(s, ab[k], bs[k])
                for sk in mma_tf32_model(s, ab[k], bb[k]):
                    c = c + sk
        else:
            for k in range(kb):
                c = mma_tf32_model(c, as_[k], bb[k])
                c = mma_tf32_model(c, ab[k], bs[k])
                c = mma_tf32_model(c, ab[k], bb[k])
        h = _act(c, act, w0)
        h = torch.cat([h, _act(torch.zeros(n, -fout % 8), act, w0)], 1)
    return h[:, :int(layers[-1]["w"].shape[1])]


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------
def _check(layers, coords: torch.Tensor, acts: LayerSpec) -> List[int]:
    """Shapes, device, type and contiguity of one call; the chain's widths."""
    if coords.dim() != 2:
        raise ValueError(f"coords: expected (N, C), got {tuple(coords.shape)}")
    if len(acts) != len(layers):
        raise ValueError("one (act, w0) per layer")
    widths = [int(coords.shape[1])] + [int(l["w"].shape[1]) for l in layers]
    for l, layer in enumerate(layers):
        if tuple(layer["w"].shape) != (widths[l], widths[l + 1]) or \
                tuple(layer["b"].shape) != (widths[l + 1],):
            raise ValueError(f"layer {l}: w {tuple(layer['w'].shape)} / b "
                             f"{tuple(layer['b'].shape)} do not chain from "
                             f"{widths[0]} coordinates")
    for name, x in [("coords", coords)] + [
            (f"layer {l} {k}", t) for l, layer in enumerate(layers)
            for k, t in layer.items()]:
        if x.device != coords.device or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {coords.device}")
    return widths


def _launch(layers, coords: torch.Tensor, acts: LayerSpec) -> torch.Tensor:
    global launches, stream_launches
    from brief_pytorch_tpu_torch.ops import build

    device = coords.device
    widths = _check(layers, coords, acts)
    p = choose_plan(widths)
    n = coords.shape[0]
    out = torch.empty((n, widths[-1]), dtype=torch.float32, device=device)
    if n == 0:
        return out
    coords = coords.contiguous()
    if p.get("stream"):
        _launch_stream(p, layers, coords, widths, acts, out)
        launches += 1
        stream_launches += 1
        return out
    n_tiles = -(-n // p["tile"])
    if n_tiles >= 1 << 31:
        raise ValueError(f"{n} coordinates is too many")
    meta = [len(layers), widths[0], widths[-1], n_tiles, p.get("stages", 0),
            8 * p["kb"][0], p["pack_blocks"]]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    wb = [t.contiguous() for layer in layers for t in (layer["w"], layer["b"])]
    ptrs = tuple(t.data_ptr() for t in wb)
    table, head = layer_table(("siren", tuple(widths), tuple(acts), ptrs),
                        lambda: chain_table(p, widths, acts, ptrs), device)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    narrow = p["layout"] == "narrow"
    per_block = p["tile"] * (WARPS if narrow else 1)
    grid = min(-(-n // per_block), sms * p["blocks_per_sm"])
    form = 0 if narrow else 1
    packed = None if narrow else torch.empty(
        p["packed_floats"], dtype=torch.float32, device=device)
    lib = build.library("fused_siren", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        build.check(lib.brief_fused_siren(
            coords.data_ptr(), out.data_ptr(),
            None if packed is None else packed.data_ptr(),
            table.data_ptr(), head, n, meta_c, form, p["inst"], grid,
            p["smem_bytes"],
            torch.cuda.current_stream(device).cuda_stream), "fused_siren")
    launches += 1
    return out


def _launch_stream(p, layers, coords: torch.Tensor, widths, acts,
                   out: torch.Tensor) -> None:
    """One call in the streamed form (csrc/chain_stream.cuh) into out."""
    from brief_pytorch_tpu_torch.ops import build
    device, n = coords.device, coords.shape[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    call = chain_stream.stream_call(p, n, sms)
    meta = [len(layers), widths[0], widths[-1], call["R"], call["S"],
            p["n_fb"], chain_stream.pack_blocks(p, widths), call["h_floats"]]
    wb = [t.contiguous() for layer in layers for t in (layer["w"], layer["b"])]
    ptrs = tuple(t.data_ptr() for t in wb)
    table, head = layer_table(
        ("siren-stream", tuple(widths), tuple(acts), ptrs),
        lambda: chain_stream.stream_table(p, widths, acts, ptrs), device)
    bufs = chain_stream.buffers(p, call, device)
    lib = build.library("fused_siren", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        build.check(lib.brief_fused_siren_stream(
            coords.data_ptr(), out.data_ptr(), chain_stream.ptr(bufs["wp"]),
            chain_stream.ptr(bufs["h"]), chain_stream.ptr(bufs["part"]),
            table.data_ptr(), head, n, (ctypes.c_int * len(meta))(*meta),
            torch.cuda.current_stream(device).cuda_stream),
            "fused_siren stream")


class _FusedChain(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    the plain chain re-run under autograd on the saved inputs, as the JAX
    package's `_bwd`; gradients for every w, b and for coords."""

    @staticmethod
    def forward(ctx, acts, coords, *flat):
        layers = [{"w": flat[2 * l], "b": flat[2 * l + 1]}
                  for l in range(len(flat) // 2)]
        ctx.acts = acts
        ctx.save_for_backward(coords, *flat)
        if coords.device.type == "cpu":
            return fused_chain_apply_reference(layers, coords, acts)
        if coords.device.type != "cuda":
            raise ValueError(f"fused_chain_apply runs on cuda or cpu, not "
                             f"{coords.device}")
        return _launch(layers, coords, acts)

    @staticmethod
    def backward(ctx, g):
        coords, *flat = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (coords, *flat)]
            layers = [{"w": leaves[1 + 2 * l], "b": leaves[2 + 2 * l]}
                      for l in range(len(flat) // 2)]
            out = fused_chain_apply_reference(layers, leaves[0], ctx.acts)
            need = [i for i, f in enumerate(ctx.needs_input_grad[1:]) if f]
            got = torch.autograd.grad(out, [leaves[i] for i in need], g)
        grads = [None] * len(leaves)
        for i, x in zip(need, got):
            grads[i] = x
        return (None, *grads)


def fused_chain_apply(layers, coords: torch.Tensor, acts: LayerSpec
                      ) -> torch.Tensor:
    """Fused forward with an autograd backward (the plain chain re-run).

    layers: [{'w': (in, out), 'b': (out,)}, ...] float32;
    coords: (N, C) float32, any N; returns (N, Cout) float32.  CUDA tensors
    launch the kernel; CPU tensors take the plain version.
    """
    flat = [t for layer in layers for t in (layer["w"], layer["b"])]
    return _FusedChain.apply(tuple(acts), coords, *flat)


def make_fused_apply(model):
    """An apply(params, coords) drop-in for model.apply using the fused
    kernel; the SIRENPos warp runs on the coordinates before it."""
    acts = chain_layer_specs(model.spec)
    pre = make_pre_encode(model.spec)

    def apply(params, coords):
        return fused_chain_apply(params["layers"], pre(coords), acts)
    return apply
