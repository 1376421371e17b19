#!/usr/bin/env python3
"""Variants of kernel 1's tiled layout, built side by side and timed in
turns on the card: where its time goes, phase by phase.

    python3 scripts/tiled_variants.py base,nodw,fwd,trunc,prof
    python3 scripts/tiled_variants.py base,w12 --shapes fleet:58,58,58,58:7:100000:10

Each variant is ops/csrc/fused_train.cu with one edit, compiled by nvcc
into build/variants/ and loaded in place of the package's library:

    base   the source as it is
    nodw   no dW phase (the gradients are wrong: timing only)
    fwd    the forward alone (no input gradients, no dW)
    trunc  the small TF32 parts truncated (split_tf32) instead of rounded
    w12    12 warps a block (6 a group of one m-tile, 168 registers)
    w16    16 warps a block (128 registers)
    prof   clock64() around each phase: cycles a warp spends in each per
           tile (forward, its group barriers, input gradients, the block
           barrier before dW, dW, the barrier after it)

Each shape (fleet:widths:layers:N:w0 as scripts/time_fused_train.py
takes it, the HiP-CT fleet by default) is timed with chip_smoke.py's
timer, every variant in turn, twice; then the card's name and power
limit.  The package's own kernel, its checks and its times are
scripts/time_fused_train.py's and chip_smoke.py's: the variants here are
for finding what paces the kernel, and only `base` computes gradients.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CU = os.path.join(ROOT, "brief_pytorch_tpu_torch", "ops", "csrc",
                  "fused_train.cu")
OUT = os.path.join(ROOT, "build", "variants")

DW = "// ---- dW over the tile's T coordinates into this warp's jobs"
IGRAD = "// ---- input gradients, last layer first: g_{l-1} = (g_l W_l^T) d_{l-1}"
SYNC_DW = "__syncthreads();   // every group's h and g are in the store"
WAIT = "brief::wide::cp_wait<0>();   // the next tile's inputs are in"
END = "__syncthreads();             // before the next tile overwrites the store"
FWD = "// ---- forward: z = [1, h] [b; W] over the chain's own k-blocks and"
GSYNC = "      group_sync(bar, bar_threads);   // the group's layer output is in"
GSYNC2 = "      if (l > 1) group_sync(bar, bar_threads);"
LOOP = ("  int par = 0;\n  for (int tile = rank; tile < d.n_tiles; "
        "tile += n_blocks, par ^= 1) {")
PARTIAL = "  // ---- this block's partial sums, written once: gradients, then loss ----"
PHASES = ("fwd", "igrad", "sync_before_dw", "dw", "end_sync", "fwd_bar",
          "igrad_bar")


def _cut(lines, start, stop):
    """Compile out the lines from the one holding `start` to the one
    before the one holding `stop`."""
    i = next(k for k, l in enumerate(lines) if start in l)
    j = next(k for k, l in enumerate(lines) if stop in l)
    lines[i] = "#if 0\n" + lines[i]
    lines[j] = "#endif\n" + lines[j]


def variant(src: str, name: str) -> str:
    lines = src.split("\n")
    if name in ("nodw", "fwd"):
        _cut(lines, DW, WAIT)
    if name == "fwd":
        _cut(lines, IGRAD, SYNC_DW)
    s = "\n".join(lines)
    tiled = s.index("// The tiled layout (ops/fused_train.py tiled_plan)")
    if name == "trunc":
        s = s[:tiled] + s[tiled:].replace("split_tf32_nearest(", "split_tf32(")
    if name in ("w12", "w16"):
        s = s.replace("constexpr int kTiledWarps = 8;",
                      f"constexpr int kTiledWarps = {name[1:]};")
    if name == "prof":
        for a, b in (
                (LOOP, "  long long pt[5] = {}, pb[2] = {}, ntile = 0;\n" + LOOP),
                ("    " + FWD, "    long long P0 = clock64();\n    " + FWD),
                (GSYNC, "      { long long q = clock64(); group_sync(bar, "
                        "bar_threads); pb[0] += clock64() - q; }"),
                ("    " + IGRAD, "    long long P1 = clock64(); pt[0] += P1 - "
                               "P0;\n    " + IGRAD),
                (GSYNC2, "      if (l > 1) { long long q = clock64(); "
                         "group_sync(bar, bar_threads); pb[1] += clock64() - "
                         "q; }"),
                ("    " + SYNC_DW, "    long long P2 = clock64(); pt[1] += P2 "
                                 "- P1;\n    " + SYNC_DW + "\n    long long P3 "
                                 "= clock64(); pt[2] += P3 - P2;"),
                ("    " + WAIT, "    long long P4 = clock64(); pt[3] += P4 - "
                              "P3;\n    " + WAIT),
                ("    " + END, "    " + END + "\n    pt[4] += clock64() - P4; "
                             "++ntile;"),
                (PARTIAL, "  if (lane == 0) {\n    for (int i = 0; i < 5; ++i)"
                          " atomicAdd(&g_prof[i], (unsigned long long)pt[i]);"
                          "\n    atomicAdd(&g_prof[5], (unsigned long long)"
                          "pb[0]);\n    atomicAdd(&g_prof[6], (unsigned long "
                          "long)pb[1]);\n    atomicAdd(&g_prof[7], (unsigned "
                          "long long)ntile);\n  }\n" + PARTIAL)):
            if a not in s:
                raise SystemExit(f"prof: the source no longer has {a!r}")
            s = s.replace(a, b, 1)
        s = s.replace("namespace {\n",
                      "namespace {\n__device__ unsigned long long g_prof[8];\n",
                      1)
        s += ('\nextern "C" int brief_prof(unsigned long long* h, int reset) '
              '{\n  if (reset) {\n    unsigned long long z[8] = {};\n    '
              'return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n  }\n'
              '  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));'
              '\n}\n')
    return s


def build_all(names):
    """Compile every variant at once; (name -> library)."""
    from brief_pytorch_tpu_torch.ops import build, fused_train as ft
    os.makedirs(OUT, exist_ok=True)
    src = open(CU).read()
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f"fused_train_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant(src, name))
        so = os.path.join(OUT, f"libfused_train_{name}.so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
             "-v", "-I", os.path.dirname(CU), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{text[-3000:]}")
        lines = text.splitlines()
        regs = [lines[i + 3].strip() for i, l in enumerate(lines)
                if "Compiling entry" in l and "tiled_kernel" in l]
        print(name, "registers:", regs, flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in ft._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def use(lib, warps: int) -> None:
    """Make the package launch through `lib`, planned for `warps` warps a
    block."""
    from brief_pytorch_tpu_torch.ops import build, chain, fused_train as ft
    build.library = lambda name, signatures: lib
    ft.TILED_WARPS, ft.TILED_THREADS = warps, 32 * warps
    ft.TILED_MT = tuple(m for m in (8, 4, 2) if warps % m == 0)
    ft._OCCUPANCY.clear()
    ft._PLANS.clear()
    chain._TABLES.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants")
    ap.add_argument("--shapes", nargs="+",
                    default=["fleet:51,54,60,66:7:100000:10"])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_train as ft
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
    from brief_pytorch_tpu_torch.parallel.block_trainer import build_stacked
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    dev = torch.device("cuda", 0)
    names = args.variants.split(",")
    libs = build_all(names)
    warps = {n: int(n[1:]) if n in ("w12", "w16") else 8 for n in names}
    for shape in args.shapes:
        _, fs, layers, n, w0, *rest = shape.split(":")
        cin, n, true = (int(rest[0]) if rest else 3), int(n), \
            [int(f) for f in fs.split(",")]
        models = [init_phi({"name": "SIREN", "coords_channel": cin,
                            "data_channel": 1, "features": f,
                            "layers": int(layers), "w0": float(w0)})
                  for f in true]
        _, params, masks = build_stacked(models, 0, device=dev)
        rng = np.random.default_rng(0)
        td = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        nb = len(true)
        c, v, w = (td(rng.uniform(-1, 1, (nb, cin, n))),
                   td(rng.uniform(0, 100, (nb, 1, n))),
                   td(rng.uniform(1, 2, (nb, 1, n))))
        th = torch.tensor([(60.0, -math.inf, 40.0, -math.inf)[i % 4]
                           for i in range(nb)], device=dev)
        acts = chain_layer_specs(models[-1].spec)
        um = list(masks[:-1]) + [None]
        call = lambda: ft.fused_train_grads_fleet(
            params["layers"], c, v, w, acts, loss_name="datal2",
            unit_masks=um, thres=th)
        times = {}
        for _ in range(2):
            for name in names:
                use(libs[name], warps[name])
                times.setdefault(name, []).append(round(cs.time_ms(call), 4))
        print(shape, times, flush=True)
        if "prof" in libs:
            lib = libs["prof"]
            lib.brief_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
            use(lib, 8)
            got = (ctypes.c_ulonglong * 8)()
            lib.brief_prof(ctypes.addressof(got), 1)
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            lib.brief_prof(ctypes.addressof(got), 0)
            tiles = got[7]
            print(shape, "cycles a warp a tile:",
                  {k: round(got[i] / tiles, 1) for i, k in enumerate(PHASES)},
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
