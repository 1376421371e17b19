#!/usr/bin/env python3
"""Time the grid-decode kernel of brief_pytorch_tpu_torch on one chain and
grid against its plain version, on the card, with chip_smoke.py's check,
timer (CUDA events, median of 25) and bounds (decode_check).

    python3 scripts/time_fused_decode.py 3-22x4-1:64x64x64 \\
        3-66x6-1:64x256x256:10 3-191x4-1:64x512x512
    python3 scripts/time_fused_decode.py --root outputs/parent \\
        3-22x4-1:256x256x256
    python3 scripts/time_fused_decode.py --layout wide 3-66x6-1:64x256x256:10
    python3 scripts/time_fused_decode.py --layout stream 3-242x4-1:64x512x512
    python3 scripts/time_fused_decode.py --profile 3-257x4-1:64x256x256

A shape is c_in-f x hidden-c_out:grid[:w0] (SIREN, w0 = 20 unless given),
or c_in-f1,f2,...-c_out:grid[:w0] for uneven hidden widths; the grid has
c_in axes, e.g. 64x512x512.  --root imports the package from another
checkout, e.g. a `git archive` of the parent commit, so that two builds
can be timed in turns in one call; the check, timer and bounds stay this
checkout's chip_smoke.py (a build whose decode is further from float64
than chip_smoke's F64_RATIO allows fails there unless --f64-ratio raises
it).  --layout forces a form of the kernel (narrow
or wide) where its plan fits, or the streamed form (ops/chain_stream.py,
which takes any chain) below the 256 features where it starts.
--profile prints, after each shape's row, one
call's device time by kernel name (torch.profiler).  Prints one JSON line
per shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def force_layout(fused_decode, layout: str) -> None:
    """Make the package's plan choose `layout` wherever its plan fits."""
    def choose(widths):
        if layout == "stream":
            from brief_pytorch_tpu_torch.ops import chain_stream
            return chain_stream.stream_plan(widths)
        p = fused_decode.narrow_plan(widths) if layout == "narrow" \
            else fused_decode.wide_plan(widths)
        if p is None:
            raise SystemExit(f"{widths}: no {layout} plan")
        return p

    fused_decode.choose_plan = choose


def kernel_profile(fn) -> dict:
    """One call of fn() under torch.profiler: device ms by kernel name
    (the name cut at its first parenthesis), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            name = e.key.split("(")[0][:80]
            out[name] = round(out.get(name, 0.0) + us / 1e3, 4)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def siren_layers(widths, w0: float, dev):
    """SIREN's initialisation (the first layer U(-1/fin, 1/fin), the others
    U(-sqrt(6/fin)/w0, sqrt(6/fin)/w0), biases likewise) from a fixed
    seed."""
    import torch
    gen = torch.Generator().manual_seed(1)
    layers = []
    for l, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
        r = 1.0 / fin if l == 0 else (6.0 / fin) ** 0.5 / w0
        w, b = (torch.rand(s, generator=gen) * 2 * r - r
                for s in ((fin, fout), (fout,)))
        layers.append({"w": w.to(dev), "b": b.to(dev)})
    return layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="+")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--layout", choices=("auto", "narrow", "wide", "stream"),
                    default="auto")
    ap.add_argument("--plain-reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--f64-ratio", type=float, default=None,
                    help="fail past this many times the plain version's "
                         "distance from float64 (default chip_smoke's "
                         "F64_RATIO['phase4']; a large value only reports "
                         "it, e.g. for a parent build)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if args.f64_ratio is not None:
        cs.F64_RATIO["phase4"] = args.f64_ratio
    import torch
    from brief_pytorch_tpu_torch.ops import fused_decode
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.layout != "auto":
        force_layout(fused_decode, args.layout)
    for shape in args.shapes:
        parts = shape.split(":")
        m = re.fullmatch(r"(\d+)-(\d+)x(\d+)-(\d+)", parts[0])
        u = re.fullmatch(r"(\d+)-([\d,]+)-(\d+)", parts[0])
        if m is not None:
            c_in, f, hidden, c_out = map(int, m.groups())
            widths = [c_in] + [f] * hidden + [c_out]
        elif u is not None:
            widths = [int(u[1])] + [int(f) for f in u[2].split(",")] + \
                [int(u[3])]
        else:
            raise SystemExit(f"bad shape {shape!r}")
        spatial = tuple(int(s) for s in parts[1].split("x"))
        w0 = float(parts[2]) if len(parts) > 2 else 20.0
        if len(spatial) != widths[0]:
            raise SystemExit(f"{shape}: {len(spatial)} axes for "
                             f"{widths[0]} coordinates")
        layers = siren_layers(widths, w0, dev)
        acts = tuple(("sine", w0) for _ in widths[2:]) + (("none", 1.0),)
        # the plain version's voxels at a time: its activations within
        # ~256 MB a layer (chains past 3,327 features)
        slab = max(4096, (1 << 26) // max(widths)) \
            if max(widths) > 3327 else None
        row = cs.decode_check(dev, shape, spatial, layers, acts,
                              plain_reps=args.plain_reps, slab=slab)
        print(json.dumps({"root": args.root, "shape": shape,
                          "widths": widths, **row}), flush=True)
        if args.profile:
            print(json.dumps({"shape": shape, "profile_ms": kernel_profile(
                lambda: fused_decode.fused_decode_grid(layers, spatial,
                                                       acts, "-1,1"))}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
