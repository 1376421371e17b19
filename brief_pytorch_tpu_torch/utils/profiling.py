"""Where the SingleTask training loop's time goes, on the card.

    python -m brief_pytorch_tpu_torch.utils.profiling [-p yaml] [--steps N]

Runs the config's training (Compress.max_steps = N, no checkpoint
artifacts: no logger) twice through NFGR.compress: once plain, for the
host-clock step time, and once under torch.profiler, for the device time
of every CUDA kernel.  Prints one JSON line:
  wall_ms_per_step    host clock over the training loop (ends in a sync)
  device_ms_per_step  summed kernel time / N (the set-up's few kernels
                      included)
  device_idle_share   1 - device_ms_per_step / wall_ms_per_step
  kernels             the ten kernels with the most device time, ms/step
  device, power_limit the card
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from brief_pytorch_tpu_torch.core import config as cfglib


def _run(opt, steps: int) -> dict:
    from brief_pytorch_tpu_torch.train.fit import NFGR
    c = opt.CompressFramework
    c.Compress.max_steps = steps
    c.Compress.checkpoints = "none"
    nfgr = NFGR(c, logger=None, seed=int(opt.Reproduc.seed), device="cuda")
    summary = nfgr.compress(opt.Dataset.data_path)
    torch.cuda.synchronize()
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-p", default="opt/SingleTask/default.yaml")
    parser.add_argument("--steps", type=int, default=1000)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA card")

    plain = _run(cfglib.load(args.p), args.steps)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run(cfglib.load(args.p), args.steps)
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3
    device_ms = sum(kernels.values()) / args.steps
    wall_ms = plain["train_s"] * 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"steps": args.steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms,
           "kernels": {k: v / args.steps for k, v in top},
           "device": torch.cuda.get_device_name(0), "power_limit": smi}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
