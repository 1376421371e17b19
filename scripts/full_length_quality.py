#!/usr/bin/env python3
"""Run configs verbatim, at their full step counts, through the port's CLI
on the card, and report the quality they reach.

    python3 scripts/full_length_quality.py opt/DivideTask/hipct.yaml \\
        opt/DivideTask/vessel.yaml [--copy-to DIR]

Each yaml runs as `python -m brief_pytorch_tpu_torch.cli.main -p <yaml>`
would run it (card 0; outputs under its Log.outputs_dir).  Prints one
JSON line per config: the last checkpoint's PSNR and SSIM, the PSNR at
every checkpoint, the wall seconds of the whole run, the host seconds in
the training steps and in the checkpoints, the fleet's buckets (DivideTask)
and the run dir; then the card's name and power limit.  --copy-to keeps
each run's performance.csv as DIR/<project>.csv.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--copy-to", default=None)
    args = ap.parse_args(argv)
    import torch
    from brief_pytorch_tpu_torch.cli import main as cli
    from brief_pytorch_tpu_torch.core import config as cfglib
    if not torch.cuda.is_available():
        print("FAIL no CUDA card", flush=True)
        return 2
    for path in args.configs:
        opt = cfglib.load(path)
        outputs = opt.Log.outputs_dir
        before = set(os.listdir(outputs)) if os.path.isdir(outputs) else set()
        t0 = time.perf_counter()
        summary = cli.main(["-p", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_dir = os.path.join(outputs, (set(os.listdir(outputs))
                                         - before).pop())
        with open(os.path.join(run_dir, "performance.csv")) as f:
            rows = list(csv.DictReader(f))
        if args.copy_to:
            os.makedirs(args.copy_to, exist_ok=True)
            shutil.copy(os.path.join(run_dir, "performance.csv"),
                        os.path.join(args.copy_to,
                                     f"{opt.Log.project_name}.csv"))
        print(json.dumps({
            "config": path, "steps": int(rows[-1]["steps"]),
            "psnr": float(rows[-1]["psnr"]), "ssim": float(rows[-1]["ssim"]),
            "psnr_by_step": {r["steps"]: float(r["psnr"]) for r in rows},
            "wall_s": wall, "train_s": summary["train_s"],
            "checkpoint_s": summary["checkpoint_s"],
            "fleet": summary.get("fleet"), "fused": summary.get("fused"),
            "run_dir": run_dir}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
