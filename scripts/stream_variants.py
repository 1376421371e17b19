#!/usr/bin/env python3
"""Variants of kernel 1's streamed wide form (chains with a layer wider
than 3,327 features), built side by side and timed in turns on the card:
where its time goes, part by part.

    python3 scripts/stream_variants.py base,fwd,train,nodw,nostore
    python3 scripts/stream_variants.py base,fwd --shapes 3-20971-1:100000

Each variant is ops/csrc/fused_train.cu with one edit, compiled by nvcc
into build/variants/ and loaded in place of the package's library:

    base     the source as it is
    fwd      the forward and the loss alone (no backward, no reduction)
    nodw     everything but the square layers' dW products and bias sums
    nostore  no z written by the forward products, no g by the thin
             backward
    w16      the square products on 16 warps a block (4 x 4, a warp 2 x 4
             mma tiles) instead of 8 (2 x 4, a warp 4 x 4)
    s3       a ring of 3 slabs instead of 4

So the backward is base - fwd, the square layers' dW base - nodw.  Only
`base` computes gradients: the others are for timing.  Then
torch.profiler's device time of each kernel of one `base` call, which
splits the rest (each kernel by name).

A shape is c_in-f1,f2,...-c_out:N (a SIREN chain, w0 = 20, datal2 with
weight_thres 0.05, as scripts/time_fused_train.py takes it) or a fleet
fleet:f1,f2,...:layers:N:w0 (true widths padded to the widest, unit
masks, thresholds 60, -inf, ...).  Each is timed with chip_smoke.py's
timer, every variant in turn, twice; then the card's name and power
limit.  The form's own checks and times are scripts/time_fused_train.py's
and chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CU = os.path.join(ROOT, "brief_pytorch_tpu_torch", "ops", "csrc",
                  "fused_train_stream.cu")
OUT = os.path.join(ROOT, "build", "variants")
SHAPES = ["3-20971-1:100000", "3-4096,4096-1:16384",
          "fleet:4000,4096:2:100000:20"]

# (variant, [(first line cut, the line after the cut)]), lines named by a
# text they hold (every such pair is cut); the markers of
# csrc/fused_train_stream.cu
BWD = "// ---- streamed: the backward"
BWD_END = "// ---- streamed: backward end"
DW = "// ---- streamed: dW"
DW_END = "// ---- streamed: dW end"
RED = "// ---- streamed: the reduction"
END = "// ---- streamed: end"
STORE = "// ---- streamed: store z"
STORE_END = "// ---- streamed: stored"
CUTS = {
    "base": [],
    "fwd": [(BWD, BWD_END), (RED, END)],
    "nodw": [(DW, DW_END)],
    "nostore": [(STORE, STORE_END)],
    "w16": [],
    "s3": [],
}
# variants that change a constant instead
SUBS = {
    "w16": [("constexpr int kWM = 2, kWN = 4;", "constexpr int kWM = 4, kWN = 4;"),
            ("constexpr int kMT = 4, kNT = 4;", "constexpr int kMT = 2, kNT = 4;")],
    "s3": [("constexpr int kGStages = 4;", "constexpr int kGStages = 3;")],
}


def _cut(lines, start, stop):
    """Compile out each run of lines from one holding `start` to the one
    before the next holding `stop`."""
    k = 0
    while True:
        i = next((k2 for k2 in range(k, len(lines)) if start in lines[k2]),
                 None)
        if i is None:
            return
        j = next(k2 for k2 in range(i + 1, len(lines)) if stop in lines[k2])
        lines[i] = "#if 0\n" + lines[i]
        lines[j] = "#endif\n" + lines[j]
        k = j + 1


def variant(src: str, name: str) -> str:
    lines = src.split("\n")
    for a, b in CUTS[name]:
        if not any(a in l for l in lines):
            raise SystemExit(f"{name}: the source no longer has {a!r}")
        _cut(lines, a, b)
    s = "\n".join(lines)
    for a, b in SUBS.get(name, []):
        if a not in s:
            raise SystemExit(f"{name}: the source no longer has {a!r}")
        s = s.replace(a, b)
    return s


def build_all(names):
    """Compile every variant at once; (name -> library)."""
    from brief_pytorch_tpu_torch.ops import build, stream as st
    os.makedirs(OUT, exist_ok=True)
    src = open(CU).read()
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f"fused_train_stream_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant(src, name))
        so = os.path.join(OUT, f"libfused_train_stream_{name}.so")
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
        for i, l in enumerate(lines):
            if "Compiling entry" in l:
                kernel = l.split("stream_cu_")[-1].split("'")[0]
                print(name, kernel, "|", " ".join(
                    x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                    if "bytes stack" in x or "registers" in x), flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in st._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


_LIBRARY = None


def use(lib) -> None:
    """Make the package launch the streamed form through `lib`."""
    global _LIBRARY
    from brief_pytorch_tpu_torch.ops import build
    if _LIBRARY is None:
        _LIBRARY = build.library
    build.library = lambda name, signatures: (
        lib if name == "fused_train_stream" else _LIBRARY(name, signatures))


def make_call(shape: str, dev):
    """(widths, the call) of one shape."""
    import numpy as np
    import torch
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_train as ft
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
    from brief_pytorch_tpu_torch.parallel.block_trainer import build_stacked
    from time_fused_train import siren_layers
    rng = np.random.default_rng(0)
    td = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    if shape.startswith("fleet:"):
        _, fs, layers, n, w0 = shape.split(":")
        true, n = [int(f) for f in fs.split(",")], int(n)
        models = [init_phi({"name": "SIREN", "coords_channel": 3,
                            "data_channel": 1, "features": f,
                            "layers": int(layers), "w0": float(w0)})
                  for f in true]
        _, params, masks = build_stacked(models, 0, device=dev)
        nb = len(true)
        c, v, w = (td(rng.uniform(-1, 1, (nb, 3, n))),
                   td(rng.uniform(0, 100, (nb, 1, n))),
                   td(rng.uniform(1, 2, (nb, 1, n))))
        th = torch.tensor([(60.0, -math.inf)[i % 2] for i in range(nb)],
                          device=dev)
        acts = chain_layer_specs(models[-1].spec)
        um = list(masks[:-1]) + [None]
        widths = [3] + [int(l["w"].shape[-1]) for l in params["layers"]]
        return widths, lambda: ft.fused_train_grads_fleet(
            params["layers"], c, v, w, acts, loss_name="datal2",
            unit_masks=um, thres=th)
    u = re.fullmatch(r"(\d+)-([\d,]+)-(\d+):(\d+)", shape)
    if u is None:
        raise SystemExit(f"bad shape {shape!r}")
    c_in, c_out, n = int(u[1]), int(u[3]), int(u[4])
    widths = [c_in] + [int(f) for f in u[2].split(",")] + [c_out]
    layers = siren_layers(widths, 20.0, dev)
    acts = tuple(("sine", 20.0) for _ in widths[2:]) + (("none", 1.0),)
    c, v, w = (td(rng.uniform(-1, 1, (c_in, n))),
               td(rng.uniform(0, 100, (c_out, n))),
               td(rng.uniform(1, 2, (c_out, n))))
    return widths, lambda: ft.fused_train_grads(
        layers, c, v, w, acts, loss_name="datal2", beta=0.01,
        weight_thres=0.05)


def profile(call) -> dict:
    """Device ms of each kernel in one call (torch.profiler, 3 calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof
    call()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in p.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)
        if t > 0 and "CUDA" in str(e.device_type):
            out[e.key[:60]] = round(t / 3 / 1e3, 4)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants")
    ap.add_argument("--shapes", nargs="+", default=SHAPES)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch
    import chip_smoke as cs
    from brief_pytorch_tpu_torch.ops import fused_train as ft
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    dev = torch.device("cuda", 0)
    names = args.variants.split(",")
    libs = build_all(names)
    for shape in args.shapes:
        widths, call = make_call(shape, dev)
        times = {}
        for _ in range(2):
            for name in names:
                use(libs[name])
                times.setdefault(name, []).append(round(cs.time_ms(call), 4))
        print(shape, widths, times, flush=True)
        if "base" in libs:
            use(libs["base"])
            print(shape, "profiler, device ms a call:", profile(call),
                  flush=True)
        ft.free_scratch()
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
