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
moves ~4.2 MB but does ~1.1 GFLOP of float32 work (~16 us at 67 TFLOP/s);
csrc/fused_siren.cu says how its design answers that.

Two layouts (`plan`): chains whose padded weights fit a block's shared
memory beside the activation tile keep them there; wider chains keep only
the tile there and read a padded copy of the weights from device memory.
`choose_plan` takes the first that fits; `kernel_plan` raises for a chain
neither holds.

`fused_chain_apply` launches the kernel for CUDA tensors and calls the
plain version, `fused_chain_apply_reference`, for CPU tensors; there is no
fallback from one to the other.  Scope: acts sine, relu, sigmoid, none;
float32.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from brief_pytorch_tpu_torch.ops.chain import (ACTS, LayerSpec,
                                               chain_layer_specs,
                                               make_pre_encode)
from brief_pytorch_tpu_torch.ops.fast_math import fast_sin

SMEM_LIMIT = 232448          # bytes of shared memory one block may use (H100)
SM_SMEM = 233472             # bytes of shared memory of one SM (H100)
TILES = (128, 64, 32)        # coordinates per block
MAX_THREADS = 512            # threads per block (__launch_bounds__)
MIN_RESIDENT = 512           # threads per SM below which coordinates are split
MAX_LAYERS = 16              # kMaxLayers of csrc/chain.cuh

launches = 0                 # kernel launches, for proof that a run used it

_SIGNATURES = {"brief_fused_siren": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def plan(widths: Sequence[int], tile: int, smem_weights: bool = True) -> Dict:
    """Layout of the kernel for a chain of `widths` = (c_in, f_1, ...,
    c_out) and `tile` coordinates per block.

    Padded parameters, per layer W (fin, round8(fout)) then the bias
    (round8(fout)): in shared memory (smem_weights) or in a device-memory
    scratch of `padded` floats.  Then two activation buffers of
    max(widths) rows of `tile` floats.  `q` threads share a coordinate,
    each computing every q-th chunk of 8 features of a layer: 1 when the SM
    holds MIN_RESIDENT coordinates anyway, else enough to reach it."""
    n_layers = len(widths) - 1
    p_off, pw_off, n_params, padded = [], [], 0, 0
    for l in range(n_layers):
        fin, fout = widths[l], widths[l + 1]
        p_off.append(n_params)
        n_params += fin * fout + fout
        pw_off.append(padded)
        padded += (fin + 1) * _round8(fout)
    buf_rows = max(widths)
    act_off = padded if smem_weights else 0
    smem_bytes = 4 * (act_off + 2 * buf_rows * tile)
    resident = tile * max(1, SM_SMEM // (smem_bytes + 1024))
    chunks = _round8(max(widths[1:])) // 8
    q = 1
    while q * resident < MIN_RESIDENT and 2 * q <= chunks and \
            2 * q * tile <= MAX_THREADS:
        q *= 2
    return {"n_params": n_params, "padded": padded, "p_off": p_off,
            "pw_off": pw_off, "act_off": act_off, "buf_rows": buf_rows,
            "tile": tile, "q": q, "threads": q * tile,
            "smem_weights": smem_weights, "smem_bytes": smem_bytes}


def choose_plan(widths: Sequence[int]) -> Optional[Dict]:
    """The largest tile whose layout fits a block's shared memory, the
    weights in shared memory if they fit at any tile; None when even 32
    coordinates' activations do not fit, or the chain is too deep."""
    if len(widths) - 1 > MAX_LAYERS:
        return None
    for smem_weights in (True, False):
        for tile in TILES:
            p = plan(widths, tile, smem_weights)
            if p["smem_bytes"] <= SMEM_LIMIT:
                return p
    return None


def kernel_plan(widths: Sequence[int]) -> Dict:
    """choose_plan, raising NotImplementedError for a plain chain the
    kernel cannot hold (there is no other route on the card)."""
    p = choose_plan(widths)
    if p is None:
        raise NotImplementedError(
            f"chain widths {list(widths)}: more than {MAX_LAYERS} layers, or "
            f"two activation buffers of 32 coordinates beyond a block's "
            f"shared memory; such chains on the fused forward kernel are "
            f"not ported yet (ROADMAP.md, 'Still to port')")
    return p


def chain_widths(spec) -> List[int]:
    return [spec.entries[0].fan_in] + [e.fan_out for e in spec.entries]


def supports(model) -> bool:
    """Whether the fused kernel can run this φ model: a plain chain
    (SIRENPos folds into the coordinates).  Raises NotImplementedError for
    such a chain that no layout holds (kernel_plan)."""
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
    global launches
    from brief_pytorch_tpu_torch.ops import build

    device = coords.device
    widths = _check(layers, coords, acts)
    p = kernel_plan(widths)
    coords = coords.contiguous()
    params = torch.cat([t.reshape(-1) for layer in layers
                        for t in (layer["w"], layer["b"])])
    n = coords.shape[0]
    out = torch.empty((n, widths[-1]), dtype=torch.float32, device=device)
    if n == 0:
        return out
    scratch = None if p["smem_weights"] else torch.empty(
        p["padded"], dtype=torch.float32, device=device)
    meta = [len(layers), widths[0], widths[-1], p["tile"], p["act_off"],
            p["buf_rows"], p["padded"]]
    for l, (act, _) in enumerate(acts):
        meta += [widths[l], widths[l + 1], ACTS.index(act), p["p_off"][l],
                 p["pw_off"][l]]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    w0_c = (ctypes.c_float * len(acts))(*[float(w0) for _, w0 in acts])
    lib = build.library("fused_siren", _SIGNATURES)
    with torch.cuda.device(device):    # the C side launches on the current one
        build.check(lib.brief_fused_siren(
            coords.data_ptr(), params.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), out.data_ptr(), n,
            meta_c, w0_c, int(p["smem_weights"]), p["threads"],
            p["smem_bytes"], torch.cuda.current_stream(device).cuda_stream),
            "fused_siren")
    launches += 1
    return out


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
    kernel_plan(chain_widths(model.spec))
    pre = make_pre_encode(model.spec)

    def apply(params, coords):
        return fused_chain_apply(params["layers"], pre(coords), acts)
    return apply
