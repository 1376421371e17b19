#!/usr/bin/env python3
"""Time the fused train kernel of brief_pytorch_tpu_torch on one chain
against its plain version, on the card, with chip_smoke.py's timer
(CUDA events, median of 25) and bound.

    python3 scripts/time_fused_train.py 3-191x4-1:100000 3-242x4-1:100000
    python3 scripts/time_fused_train.py --root outputs/parent 3-191x4-1:100000

A shape is c_in-f x hidden-c_out:N (SIREN, w0 = 20, datal2 with
weight_thres 0.05, as chip_smoke.py phase 3), or a fleet
fleet:f1,f2,...:layers:N:w0 (chip_smoke.fleet_check: SIREN chains of true
widths f1, f2, ... padded to the widest, thresholds 60, -inf, 40, -inf,
...; checked and timed as phase 6 does).  --root imports the package
(and chip_smoke.py) from another checkout, e.g. a `git archive` of the
parent commit, so that two builds can be timed in turns in one call.
Prints one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="+")
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version too")
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
    for shape in args.shapes:
        if shape.startswith("fleet:"):
            _, fs, layers_, n, w0 = shape.split(":")
            true = tuple(int(f) for f in fs.split(","))
            padded = [3] + [max(true)] * (int(layers_) - 1) + [1]
            thres = [(60.0, -np.inf, 40.0, -np.inf)[i % 4]
                     for i in range(len(true))]
            row = cs.fleet_check(dev, np.random.default_rng(0), true,
                                 int(layers_), float(w0), int(n), thres,
                                 fused_train.choose_plan(padded)["layout"])
            print(json.dumps({"root": args.root, "shape": shape,
                              **{k: row[k] for k in ("layout", "ms",
                                                     "plain_ms",
                                                     "bound_ms")}}),
                  flush=True)
            continue
        m = re.fullmatch(r"(\d+)-(\d+)x(\d+)-(\d+):(\d+)", shape)
        if m is None:
            raise SystemExit(f"bad shape {shape!r}")
        c_in, f, hidden, c_out, n = map(int, m.groups())
        model = init_phi({"name": "SIREN", "coords_channel": c_in,
                          "data_channel": c_out, "features": f,
                          "layers": hidden + 1, "w0": 20})
        layers = model.init(torch.Generator().manual_seed(1), dev)["layers"]
        acts = chain_layer_specs(model.spec)
        widths = [c_in] + [f] * hidden + [c_out]
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

        (lk, gk), (lp, gp) = k(), p()
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
        print(json.dumps({"root": args.root, "shape": shape,
                          "layout": fused_train.choose_plan(widths)["layout"],
                          "max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": b, "bound_by": by}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
