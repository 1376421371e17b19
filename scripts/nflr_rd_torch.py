"""An NFLR rate-distortion point on the 64^3 brain fixture, through the
PyTorch port (brief_pytorch_tpu_torch.nflr) — the twin of
scripts/nflr_rd.py, with its arguments and defaults.

Trains a variant on the volume, SGA-compresses it to a real rANS
container, decodes it from memory and from the file, and prints one JSON
line: the RD point (file bytes, ratio, bits per voxel, PSNR on the uint16
range, both decodes equal), and the run's speed on its device: steps/s,
wall, CUDA-event and kernel ms per step, the device's idle share, with the
card's name and power limit (nvidia-smi), and the rANS backend used.  The
line is appended to <out>/results.jsonl.

    python3 scripts/nflr_rd_torch.py --variant NFLR_Coding_AutoDecoder \\
        --steps 30000 --sga-steps 3000 --lambda 8000 --out outputs/nflr_rd

Runs on CUDA card 0; --device cpu runs on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(_HERE, "dataset", "brain", "64x64x64",
                       "brain-64_128-64_128-192_256.tif")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="NFLR_Coding_AutoDecoder")
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--sga-steps", type=int, default=3000)
    ap.add_argument("--lambda", dest="Lambda", type=float, default=2000.0)
    ap.add_argument("--features", type=int, default=48)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--y-channel", type=int, default=24)
    ap.add_argument("--ps", type=int, default=8)
    ap.add_argument("--ol", type=int, default=2)
    ap.add_argument("--sample-size", type=int, default=4096)
    ap.add_argument("--dec-sample-size", type=int, default=32768)
    ap.add_argument("--argmin-steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default="outputs/nflr_rd")
    ap.add_argument("--tag", default="")
    ap.add_argument("--volume", default=FIXTURE,
                    help="volume to compress (default: the 64^3 fixture)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA card index (default: card 0)")
    args = ap.parse_args(argv)
    volume = os.path.abspath(args.volume)

    import torch
    from brief_pytorch_tpu_torch.nflr import rans
    from brief_pytorch_tpu_torch.nflr.framework import init_compressframework
    from brief_pytorch_tpu_torch.nflr.rd import (rd_opt, rd_point,
                                                 train_on_volume)

    os.makedirs(args.out, exist_ok=True)
    tag = args.tag or f"{args.variant}_s{args.steps}_L{int(args.Lambda)}"
    opt = rd_opt(args.variant, args.features, args.layers, args.y_channel,
                 args.ps, args.ol, args.sample_size, args.dec_sample_size,
                 args.steps, args.sga_steps, args.argmin_steps, args.lr,
                 args.Lambda)
    fw = init_compressframework(opt, device=args.device)
    if fw.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    timing, losses = train_on_volume(
        fw, volume, args.steps,
        log=lambda msg: print(f"[{tag}] {msg}", flush=True))
    train_s = time.time() - t0
    t1 = time.time()
    point = rd_point(fw, volume, os.path.join(args.out, tag + ".zip"))
    compress_s = time.time() - t1
    on_card = fw.device.type == "cuda"
    result = {
        "tag": tag, "platform": "gpu" if on_card else "cpu",
        "variant": args.variant, "train_steps": args.steps,
        "sga_steps": args.sga_steps, "Lambda": args.Lambda,
        "features": args.features, "y_channel": args.y_channel,
        "ps": args.ps, "ol": args.ol, "volume": os.path.basename(volume),
        **{k: point[k] for k in ("file_bytes", "ratio", "bits_per_voxel",
                                 "psnr_uint16", "mse",
                                 "bits_roundtrip_equal")},
        "train_minutes": train_s / 60, "compress_s": compress_s,
        "first_loss": losses[0][1], "final_loss": losses[-1][1],
        **{k: v for k, v in timing.items() if k != "wall_s"},
        "rans_backend": rans.backend(),
        "device": torch.cuda.get_device_name(fw.device) if on_card else "cpu",
        "card": card() if on_card else None,
    }
    print(json.dumps(result), flush=True)
    with open(os.path.join(args.out, "results.jsonl"), "a") as f:
        f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
