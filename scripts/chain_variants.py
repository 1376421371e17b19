#!/usr/bin/env python3
"""Where the wide form of kernels 2 and 3 (csrc/chain_tc.cuh
chain_wide_kernel) spends its time on chains wider than 3,327 features:
variants of a checkout's kernels with the chain's layer loop cut short,
built side by side and timed in turns on the card.

    python3 scripts/chain_variants.py --root outputs/parent
    python3 scripts/chain_variants.py --root outputs/parent \\
        decode:3-20971-1:64x64x64 siren:3-4096,4096-1:65536

Each variant is the checkout's ops/csrc with one edit of chain_tc.cuh,
compiled by nvcc into build/variants/<name>/ and loaded in place of the
checkout's fused_decode and fused_siren libraries:

    base     the source as it is
    nolast   the layer loop stops before the last layer (layer 0, and any
             square layer, with their scratch writes)
    first    the layer loop stops after layer 0 (its scratch writes)

The slab ring's producer still streams every layer's slabs, one for each
slab a warp consumes, so a cut variant reads other layers' slabs in
place of its own: its time is the cut loop's work, its outputs are
meaningless.  So the last layer is base - nolast, the square layers
nolast - first.  A shape is decode:c_in-f1,...-c_out:grid or
siren:c_in-f1,...-c_out:N (SIREN weights, w0 = 20); each is timed with
chip_smoke.py's timer, every variant in turn, twice; then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ["decode:3-20971-1:64x64x64", "siren:3-4096,4096-1:65536"]
LOOP = "for (int l = 0; l < L; ++l) {"
SUBS = {"base": None, "nolast": "for (int l = 0; l < L - 1; ++l) {",
        "first": "for (int l = 0; l < 1; ++l) {"}


def build_all(root: str, names):
    """Compile every variant's two libraries at once; name -> {library
    name: CDLL}."""
    from brief_pytorch_tpu_torch.ops import build, fused_decode, fused_siren
    csrc = os.path.join(root, "brief_pytorch_tpu_torch", "ops", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(HERE, "build", "variants", name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        tc = os.path.join(out, "chain_tc.cuh")
        src = open(tc).read()
        if src.count(LOOP) != 1:
            raise SystemExit(f"{tc}: the wide kernel's layer loop not found")
        if SUBS[name]:
            src = src.replace(LOOP, SUBS[name])
        with open(tc, "w") as f:
            f.write(src)
        for lib in ("fused_decode", "fused_siren"):
            so = os.path.join(out, f"lib{lib}.so")
            procs[(name, lib)] = (subprocess.Popen(
                [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-I", out, "-o", so, os.path.join(out, f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so)
    sigs = {"fused_decode": fused_decode._SIGNATURES,
            "fused_siren": fused_siren._SIGNATURES}
    libs = {}
    for (name, lib), (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {lib}:\n{text[-3000:]}")
        cdll = ctypes.CDLL(so)
        for fn, argtypes in sigs[lib].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[lib] = cdll
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="*", default=SHAPES)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--variants", default="base,nolast,first")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(HERE, "scripts"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from brief_pytorch_tpu_torch.ops import build, fused_decode, fused_siren
    from time_fused_decode import siren_layers
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    dev = torch.device("cuda", 0)
    names = args.variants.split(",")
    libs = build_all(root, names)
    own = build.library
    for shape in args.shapes:
        kind, chain, size = shape.split(":")
        u = re.fullmatch(r"(\d+)-([\d,]+)-(\d+)", chain)
        widths = [int(u[1])] + [int(f) for f in u[2].split(",")] + [int(u[3])]
        layers = siren_layers(widths, 20.0, dev)
        acts = tuple(("sine", 20.0) for _ in widths[2:]) + (("none", 1.0),)
        if kind == "decode":
            spatial = tuple(int(s) for s in size.split("x"))
            fn = lambda: fused_decode.fused_decode_grid(layers, spatial, acts,
                                                        "-1,1")
        else:
            rows = torch.rand(int(size), widths[0], device=dev) * 2 - 1
            fn = lambda: fused_siren.fused_chain_apply(layers, rows, acts)
        times = {}
        for rep in range(2):
            for name in names:
                build.library = lambda lib, sig, n=name: libs[n].get(lib) \
                    or own(lib, sig)
                times.setdefault(name, []).append(cs.time_ms(fn, reps=10))
        build.library = own
        print(shape, " ".join(f"{k}={v}" for k, v in times.items()),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
