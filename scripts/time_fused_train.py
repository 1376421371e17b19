#!/usr/bin/env python3
"""Time the fused train kernel of brief_pytorch_tpu_torch on one chain
against its plain version, on the card, with chip_smoke.py's timer
(CUDA events, median of 25) and bound.

    python3 scripts/time_fused_train.py 3-191x4-1:100000 3-242x4-1:100000
    python3 scripts/time_fused_train.py --root outputs/parent 3-191x4-1:100000
    python3 scripts/time_fused_train.py --layout tiled 3-22x4-1:262144

A shape is c_in-f x hidden-c_out:N (SIREN, w0 = 20, datal2 with
weight_thres 0.05, as chip_smoke.py phase 3), c_in-f1,f2,...-c_out:N for
uneven hidden widths (SIREN_Pyramid, SIRENFT; SIREN's initialisation
rule per layer), or a fleet
fleet:f1,f2,...:layers:N:w0[:c_in] (chip_smoke.fleet_check: SIREN chains
of true widths f1, f2, ... padded to the widest, c_in coordinates (3
unless given), thresholds 60, -inf, 40, -inf, ...; checked and timed as
phase 6 does).  The fleets of the DivideTask configs:

    fleet:51,54,60,66:7:100000:10      hipct.yaml (by_var)
    fleet:58,58,58,58:7:100000:10      vessel.yaml (by_size)
    fleet:28,28,28,28:7:100000:10      neuron.yaml (by_size)
    fleet:47,46,44,45:5:100000:10:2    the 2048^2 PNG, total_1_2_2  --root imports the package
(and chip_smoke.py) from another checkout, e.g. a `git archive` of the
parent commit, so that two builds can be timed in turns in one call.
--layout forces a layout of the kernel (narrow, tiled or wide) where its
plan fits, or the wide layout's streamed form (stream) at any width, to
time one shape in two layouts.  --relu-float64 holds a
fleet's relu/sigmoid chain to the plain version evaluated in float64 (as
chip_smoke.py phase 20d does for its 20-layer fleet, where the float32
plain version itself is past the 1e-4 tolerance).  Prints one JSON line per
shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def force_layout(fused_train, layout: str) -> None:
    """Make the package's plan choose `layout` wherever its plan fits."""
    chosen = fused_train.choose_plan

    def choose(widths):
        if layout == "tiled":
            p = fused_train.tiled_plan(widths)
            ok = p["jobs"] and p["smem_bytes"] <= fused_train.SMEM_LIMIT
        elif layout == "wide" and hasattr(fused_train, "wide_choose"):
            p = fused_train.wide_choose(widths)
            ok = p is not None
        elif layout == "wide":   # a build before the tensor-core wide layout
            tile = fused_train.wide.choose_tile(
                lambda t: fused_train.wide_plan(widths, t)["smem_bytes"],
                fused_train.SMEM_LIMIT, fused_train.SM_SMEM)
            p, ok = fused_train.wide_plan(widths, tile or 8), tile is not None
        elif layout == "stream":   # the streamed form at any width
            p = fused_train.stream_form.stream_plan(widths)
            ok = True
        else:   # the narrow layout at any occupancy it fits
            best = getattr(fused_train, "narrow_plan", chosen)
            p = best(widths)
            ok = p is not None and p["layout"] == layout
        if not ok:
            raise SystemExit(f"{widths}: no {layout} plan")
        return p

    fused_train.choose_plan = choose
    fused_train._PLANS.clear()


def siren_layers(widths, w0: float, dev):
    """SIREN's initialisation (the first layer U(-1/fin, 1/fin), the others
    U(-sqrt(6/fin)/w0, sqrt(6/fin)/w0), biases likewise) for a chain of
    any widths, from a fixed seed."""
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
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version too")
    ap.add_argument("--layout", choices=("auto", "narrow", "tiled", "wide",
                                         "stream"),
                    default="auto")
    ap.add_argument("--relu-float64", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    import chip_smoke as cs
    from brief_pytorch_tpu_torch.models.phi import init_phi
    from brief_pytorch_tpu_torch.ops import fused_train
    from brief_pytorch_tpu_torch.ops.chain import chain_layer_specs
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.layout != "auto":
        force_layout(fused_train, args.layout)
    for shape in args.shapes:
        if shape.startswith("fleet:"):
            _, fs, layers_, n, w0, *rest = shape.split(":")
            cin = int(rest[0]) if rest else 3
            true = tuple(int(f) for f in fs.split(","))
            padded = [cin] + [max(true)] * (int(layers_) - 1) + [1]
            thres = [(60.0, -np.inf, 40.0, -np.inf)[i % 4]
                     for i in range(len(true))]
            row = cs.fleet_check(dev, np.random.default_rng(0), true,
                                 int(layers_), float(w0), int(n), thres,
                                 fused_train.choose_plan(padded)["layout"],
                                 cin=cin, relu_reference="float64"
                                 if args.relu_float64 else "plain")
            print(json.dumps({"root": args.root, "shape": shape,
                              **{k: row.get(k) for k in (
                                  "layout", "tile", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "tc_bound_ms")}}),
                  flush=True)
            continue
        m = re.fullmatch(r"(\d+)-(\d+)x(\d+)-(\d+):(\d+)", shape)
        u = re.fullmatch(r"(\d+)-([\d,]+)-(\d+):(\d+)", shape)
        if m is not None:
            c_in, f, hidden, c_out, n = map(int, m.groups())
            model = init_phi({"name": "SIREN", "coords_channel": c_in,
                              "data_channel": c_out, "features": f,
                              "layers": hidden + 1, "w0": 20})
            layers = model.init(torch.Generator().manual_seed(1),
                                dev)["layers"]
            acts = chain_layer_specs(model.spec)
            widths = [c_in] + [f] * hidden + [c_out]
        elif u is not None:
            c_in, c_out, n = int(u[1]), int(u[3]), int(u[4])
            widths = [c_in] + [int(f) for f in u[2].split(",")] + [c_out]
            layers = siren_layers(widths, 20.0, dev)
            acts = tuple(("sine", 20.0) for _ in widths[2:]) + (("none",
                                                                 1.0),)
        else:
            raise SystemExit(f"bad shape {shape!r}")
        rng = np.random.default_rng(0)
        to_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        coords = to_dev(rng.uniform(-1, 1, (c_in, n)))
        values = to_dev(rng.uniform(0, 100, (c_out, n)))
        weights = to_dev(rng.uniform(1, 2, (c_out, n)))
        kw = dict(loss_name="datal2", beta=0.01, weight_thres=0.05)

        def k():
            return fused_train.fused_train_grads(layers, coords, values,
                                                 weights, acts, **kw)

        def p():
            return fused_train.fused_train_grads_reference(
                layers, coords, values, weights, acts, **kw)

        lk, gk = k()
        fused_train.free_scratch()     # room for the plain version's
        torch.cuda.empty_cache()       # activations at the widest shapes
        lp, gp = p()
        torch.cuda.synchronize()
        err = cs.compare_grads(lk[None], [{a: b[None] for a, b in g.items()}
                                          for g in gk["layers"]], lp[None],
                               [{a: b[None] for a, b in g.items()}
                                for g in gp["layers"]], shape)
        ms = cs.time_ms(k)
        plain = cs.time_ms(p, reps=5) if args.plain else None
        n_par = sum(l["w"].numel() + l["b"].numel() for l in layers)
        b, by = cs.bound_ms(4 * (n * (c_in + 2 * c_out) + 2 * n_par + 1),
                            cs.train_flops(widths, acts, n))
        plan = fused_train.choose_plan(widths)
        print(json.dumps({"root": args.root, "shape": shape,
                          "widths": widths, "layout": plan["layout"],
                          "stream": bool(plan.get("stream")),
                          "tile": plan.get("block"),
                          "max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": b, "bound_by": by,
                          "tc_bound_ms": cs.train_tc_bound_ms(
                              widths, acts, n, 4 * (n * (c_in + 2 * c_out)
                                                    + 2 * n_par + 1))}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
