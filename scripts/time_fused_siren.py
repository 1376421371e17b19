#!/usr/bin/env python3
"""Time the batch-major forward kernel of brief_pytorch_tpu_torch
(ops/fused_siren.py) at chip_smoke.py's SIREN_CASES with that checkout's
chip_smoke.siren_check (checked against its plain version and autograd,
CUDA events, median of 25).

    python3 scripts/time_fused_siren.py
    python3 scripts/time_fused_siren.py --root outputs/parent
    python3 scripts/time_fused_siren.py --cases wide-1024,reach-4096,reach-20971
    python3 scripts/time_fused_siren.py --layout stream \
        --cases wide,3-242x4-1:262144

--cases times only the named cases, of SIREN_CASES and of phase 20's
REACH_SIREN (the streamed form past 256 features: wide-1024, SIREN
3-1024x4-1 at N = 65,536; reach-4096, [3, 4096, 4096, 1] at N = 65,536;
reach-20971, 3-20971-1 at N = 65,536), or SIREN shapes c_in-fxh-c_out:N
(w0 = 20), e.g. 3-257x4-1:65536.  --layout stream forces the streamed
form (ops/chain_stream.py) below the 256 features where it starts (e.g.
`wide`, 3-186x4-1 at N = 262,144).

--root imports the package and chip_smoke.py from another checkout, e.g.
a `git archive` of the parent commit, so that two builds can be timed in
turns in one call.  Prints one JSON line per case (its form and
tensor-core bound where that checkout's siren_check reports them), then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def shape_case(shape: str):
    """(label, SIREN config, N) of c_in-fxh-c_out:N."""
    m = re.fullmatch(r"(\d+)-(\d+)x(\d+)-(\d+):(\d+)", shape)
    if m is None:
        raise SystemExit(f"unknown case {shape!r}")
    c_in, f, hidden, c_out, n = map(int, m.groups())
    return shape, {"name": "SIREN", "features": f, "layers": hidden + 1,
                   "coords_channel": c_in, "data_channel": c_out}, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cases", default=None,
                    help="comma-separated labels or shapes (default: "
                         "SIREN_CASES)")
    ap.add_argument("--layout", choices=("auto", "stream"), default="auto")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cases = [c[:3] for c in cs.SIREN_CASES]
    if args.cases:
        known = {c[0]: c[:3] for c in cases + list(cs.REACH_SIREN)}
        cases = [known.get(c) or shape_case(c)
                 for c in args.cases.split(",")]
    if args.layout == "stream":
        from brief_pytorch_tpu_torch.ops import chain_stream, fused_siren
        fused_siren.choose_plan = chain_stream.stream_plan
    for label, cfg, n in cases:
        row = cs.siren_check(dev, label, cfg, n)
        torch.cuda.empty_cache()
        print(json.dumps({"root": args.root, "case": label, "n": n,
                          "ms": row["ms"], "bound_ms": row["bound_ms"],
                          "tc_bound_ms": row.get("tc_bound_ms"),
                          "layout": row.get("layout"),
                          "form": row.get("form"),
                          "inst": row.get("inst"),
                          "max_abs_err": row["max_abs_err"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
