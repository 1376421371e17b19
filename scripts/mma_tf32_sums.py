#!/usr/bin/env python3
"""How mma.sync.m16n8k8 TF32 sums on the card, and what that does to the
tensor-core chain (csrc/chain_tc.cuh) of kernels 2 and 3.

    python3 scripts/mma_tf32_sums.py [--tiles 4096] [--side 32]

1. Builds a probe with nvcc into build/ (one warp a tile: D = C + A B,
   16 x 8 x 8, TF32 A and B) and runs it on random tiles of three kinds:
   `normal` (A, B, C standard normal), `spread` (each entry's exponent
   drawn from 2^-20 .. 2^20) and `cancel` (C close to -A B).  Per kind,
   one JSON line: the share of outputs equal bit for bit to
   ops/tc_model.py mma_tf32_model, to the exact sum rounded to
   nearest, and to the exact sum rounded toward zero.
2. Runs kernel 2 (fused_decode_grid) and kernel 3 (fused_chain_apply)
   on the SingleTask default chain (SIREN 5 x 22, w0 20, random weights
   from a seed) over the same side^3 grid, and the plain version on the
   card.  One JSON line per route: its max and mean distance from a
   float64 evaluation (each layer's products and sums in float64, the
   pre-activation rounded once to float32).  (On a relu chain kernel 3
   equals fused_siren.chain_tc_model bit for bit: the card test
   test_fused_siren_sums_are_the_model.  On a sine chain they differ
   where the device's and the CPU's fast_sin differ in a last bit.)
Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// tile i: a (16, 8) row-major, b (8, 8) row-major (k, n), c and d (16, 8)
__global__ void probe(const float* a, const float* b, const float* c,
                      float* d, int tiles) {
  const int tile = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= tiles) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* A = a + tile * 128;
  const float* B = b + tile * 64;
  const float* C = c + tile * 128;
  float* D = d + tile * 128;
  const uint32_t a0 = __float_as_uint(A[g * 8 + t]);
  const uint32_t a1 = __float_as_uint(A[(g + 8) * 8 + t]);
  const uint32_t a2 = __float_as_uint(A[g * 8 + t + 4]);
  const uint32_t a3 = __float_as_uint(A[(g + 8) * 8 + t + 4]);
  const uint32_t b0 = __float_as_uint(B[t * 8 + g]);
  const uint32_t b1 = __float_as_uint(B[(t + 4) * 8 + g]);
  float r[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  D[g * 8 + 2 * t] = r[0];
  D[g * 8 + 2 * t + 1] = r[1];
  D[(g + 8) * 8 + 2 * t] = r[2];
  D[(g + 8) * 8 + 2 * t + 1] = r[3];
}
extern "C" int run_probe(const float* a, const float* b, const float* c,
                         float* d, int tiles) {
  probe<<<(tiles + 7) / 8, 256>>>(a, b, c, d, tiles);
  return (int)cudaDeviceSynchronize();
}
"""


def build_probe() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "mma_tf32_sums.cu")
    lib = os.path.join(build, "mma_tf32_sums.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    return ctypes.CDLL(lib)


def tiles_of(kind: str, n: int, rng):
    import numpy as np
    import torch

    from brief_pytorch_tpu_torch.ops.tc_model import tf32_split

    def draw(shape):
        x = rng.standard_normal(shape)
        if kind == "spread":
            x = x * 2.0 ** rng.integers(-20, 21, shape)
        return torch.from_numpy(x.astype(np.float32))

    a = tf32_split(draw((n, 16, 8)))[0]
    b = tf32_split(draw((n, 8, 8)))[0]
    c = draw((n, 16, 8))
    if kind == "cancel":
        c = -(a.double() @ b.double()).float() + 1e-3 * c
    return a, b, c


def sums(lib, dev, rng, n_tiles: int) -> None:
    import torch

    from brief_pytorch_tpu_torch.ops.tc_model import mma_tf32_model
    for kind in ("normal", "spread", "cancel"):
        a, b, c = tiles_of(kind, n_tiles, rng)
        ad, bd, cd = (t.contiguous().to(dev) for t in (a, b, c))
        d = torch.empty_like(cd)
        rc = lib.run_probe(ctypes.c_void_p(ad.data_ptr()),
                           ctypes.c_void_p(bd.data_ptr()),
                           ctypes.c_void_p(cd.data_ptr()),
                           ctypes.c_void_p(d.data_ptr()), n_tiles)
        if rc != 0:
            raise RuntimeError(f"probe: CUDA error {rc}")
        d = d.cpu().reshape(-1, 8)
        model = torch.cat([mma_tf32_model(c[i], a[i], b[i])
                           for i in range(n_tiles)])
        exact = c.double() + a.double() @ b.double()
        rn = exact.float().reshape(-1, 8)
        rz = rn.clone()
        over = rn.double().abs() > exact.reshape(-1, 8).abs()
        rz[over] = torch.nextafter(rn[over], torch.zeros_like(rn[over]))
        print(json.dumps({
            "tiles": kind, "n": int(d.numel()),
            "equal_model": float((d == model).float().mean()),
            "equal_round_nearest": float((d == rn).float().mean()),
            "equal_round_toward_zero": float((d == rz).float().mean())}),
            flush=True)


def chains(dev, side: int) -> None:
    import torch

    from brief_pytorch_tpu_torch.core.coords import index_to_coords
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_decode, fused_siren
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs

    model = init_phi({"name": "SIREN", "features": 22, "coords_channel": 3,
                      "data_channel": 1, "layers": 5, "w0": 20})
    params = model.init(torch.Generator().manual_seed(2), dev)
    layers = params["layers"]
    acts = chain_layer_specs(model.spec)
    spatial = [side] * 3
    coords = index_to_coords(torch.arange(side ** 3, device=dev), spatial,
                             "-1,1")
    routes = {
        "kernel 2": fused_decode.fused_decode_grid(layers, spatial, acts,
                                                   "-1,1"),
        "kernel 3": fused_siren.fused_chain_apply(layers, coords, acts),
        "plain": fused_siren.fused_chain_apply_reference(layers, coords,
                                                         acts)}
    cpu = [{k: t.cpu() for k, t in layer.items()} for layer in layers]
    x = coords.cpu()
    h = x.double()
    for layer, (act, w0) in zip(cpu, acts):
        z = (h @ layer["w"].double() + layer["b"].double()).float()
        h = fused_siren._act(z, act, w0).double()
    for name, out in routes.items():
        err = (out.cpu().double() - h).abs()
        print(json.dumps({"route": name, "chain": "SIREN 5 x 22",
                          "n": side ** 3,
                          "max_abs_err_vs_float64": float(err.max()),
                          "mean_abs_err_vs_float64": float(err.mean())}),
              flush=True)


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=4096)
    ap.add_argument("--side", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sums(build_probe(), dev, np.random.default_rng(0), args.tiles)
    chains(dev, args.side)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
